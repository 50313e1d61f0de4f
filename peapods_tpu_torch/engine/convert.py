"""Carry a simulation state between the reference engine and the port.

The reference's state is a dict of JAX arrays with ``base_keys`` as typed
threefry keys; in numpy form (``np.asarray`` of every entry, and
``jax.random.key_data(base_keys)`` under ``base_keys``) it maps one to one
onto the port's state, whose spins and PT tensors live on a torch device.
With these two functions the tests put the same state into both engines.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_reference", "to_reference"]

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
    as key data)."""
    out = {k: state[k].cpu().numpy() for k in _DEVICE_KEYS}
    out.update({k: np.int32(state[k]) for k in _HOST_KEYS})
    out["base_keys"] = np.asarray(state["base_keys"], np.uint32).copy()
    return out
