"""Carry a simulation state between the reference engine and the port.

The reference's state is a dict of JAX arrays with ``base_keys`` as typed
threefry keys; in numpy form (``np.asarray`` of every entry, and
``jax.random.key_data(base_keys)`` under ``base_keys``) it maps one to one
onto the port's state, whose spins and PT tensors live on a torch device.
With these two functions the tests put the same state into both engines.

:func:`write_checkpoint` and :func:`read_checkpoint` write and read the
checkpoint file of both engines (peapods_tpu/engine/simulation.py:
213-252): an ``.npz`` of the state's arrays in this layout but
``base_keys``, with ``__constructor_seed`` and the key data as
``__key_data``.  The 64-bit dynamics seed is written as ``int64`` where it
fits (the JAX package's form) and as ``uint64`` where it does not; either
reader takes ``int(...)`` of it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_reference", "to_reference", "write_checkpoint", "read_checkpoint"]

_DEVICE_KEYS = ("spins", "system_ids", "pt_edge_attempts",
                "pt_edge_acceptances", "pt_round_trips", "pt_trip_state")
_HOST_KEYS = ("counter", "warmup", "pt_parity")


def from_reference(ref: dict, device) -> dict:
    """Port state from the reference's state in numpy form."""
    state = {k: torch.from_numpy(np.array(ref[k])).to(device)
             for k in _DEVICE_KEYS}
    state.update({k: np.int32(ref[k]) for k in _HOST_KEYS})
    state["base_keys"] = np.asarray(ref["base_keys"], np.uint32).copy()
    return state


def to_reference(state: dict) -> dict:
    """The port's state as numpy, in the reference's layout (``base_keys``
    as key data): copies, which the run does not change."""
    out = {k: state[k].cpu().numpy().copy() for k in _DEVICE_KEYS}
    out.update({k: np.int32(state[k]) for k in _HOST_KEYS})
    out["base_keys"] = np.asarray(state["base_keys"], np.uint32).copy()
    return out


def write_checkpoint(path, ref: dict, constructor_seed: int) -> None:
    """Write the state ``ref`` (the reference's numpy form) to ``path``."""
    flat = {k: np.asarray(v) for k, v in ref.items() if k != "base_keys"}
    seed = int(constructor_seed)
    flat["__constructor_seed"] = (np.int64(seed) if seed < 1 << 63
                                  else np.uint64(seed))
    flat["__key_data"] = np.asarray(ref["base_keys"], np.uint32)
    np.savez(path, **flat)


def read_checkpoint(path) -> tuple[dict, int]:
    """The state in the reference's numpy form (0-d entries as numpy
    scalars, ``base_keys`` as key data) and the constructor seed of the
    file at ``path``."""
    with np.load(path) as data:
        ref = {k: (data[k] if data[k].ndim else data[k][()]) for k in data.files
               if not k.startswith("__")}
        ref["base_keys"] = np.asarray(data["__key_data"], np.uint32).copy()
        return ref, int(data["__constructor_seed"])
