"""IsingSimulation: the stateful engine behind the port's ``Ising``.

Counterpart of ``peapods_tpu/engine/simulation.py`` (:75-436) for the slice
the port runs today: a 2D square lattice with even extents, one replica,
Metropolis or Gibbs sweeps, optional SW or Wolff cluster updates (with or
without cluster statistics), optional parallel tempering (both schedules),
every sweep measured.  The device is explicit (``device="cuda"`` by
default); a CUDA device runs the hand-written kernels, ``device="cpu"`` their
plain torch versions, and nothing ever falls back from one to the other.

``state`` has the reference's keys: ``spins`` int8 ``[d, n_systems,
n_spins]`` stored by system on the device, ``system_ids`` int32 ``[d, R,
T]``, the PT counters, and on the host ``base_keys`` (uint32 ``[d, 2]``
threefry key data), ``counter``, ``warmup`` and ``pt_parity``.
"""

from __future__ import annotations

import contextlib
import signal
import threading

import numpy as np
import torch

from ..ops.lattice import Lattice
from ..ops.tempering import init_trip_state
from . import seeds as seedlib
from .config import (
    ClusterUpdate,
    SimConfig,
    not_ported,
    parse_cluster_action,
    parse_cluster_mode,
    parse_pt_schedule,
    parse_sweep_mode,
)
from .loop import Runtime, init_accumulators, run_chunk
from .results import finalize

__all__ = ["IsingSimulation", "resolve_device"]


def resolve_device(device) -> torch.device:
    """The torch device to run on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} was requested but torch sees no CUDA "
                "device; pass device='cpu' to run the plain torch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


@contextlib.contextmanager
def _defer_sigint():
    """Hold Ctrl-C while a chunk is being launched.

    Kernels update the state in place, so an interrupt between two launches
    would leave spins ahead of the counter; SIGINT is parked until the chunk
    and its bookkeeping are done, then re-raised (the reference's contract,
    peapods_tpu/engine/simulation.py:46-72).
    """
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    hits = []
    try:
        prev = signal.signal(signal.SIGINT, lambda *_: hits.append(None))
    except ValueError:  # non-main interpreter contexts
        yield
        return
    try:
        yield
    finally:
        signal.signal(signal.SIGINT, prev)
    if hits:
        raise KeyboardInterrupt


class IsingSimulation:
    """Holds the lattice constants and the batched realization state."""

    def __init__(
        self,
        lattice_shape,
        couplings,
        temperatures,
        n_replicas=None,
        neighbor_offsets=None,
        seed=None,
        default_chunk=256,
        mesh="auto",
        device="cuda",
    ):
        if neighbor_offsets is not None:
            not_ported("neighbor_offsets (non-square lattices)", "4a")
        if mesh not in ("auto", None):
            not_ported("a device mesh", "9")
        n_replicas = int(n_replicas) if n_replicas is not None else 1
        if n_replicas != 1:
            not_ported(f"n_replicas={n_replicas}", "7")
        lattice = Lattice(lattice_shape)
        self.lattice = lattice
        self.device = resolve_device(device)

        couplings = np.asarray(couplings, dtype=np.float32)
        expected_single = tuple(lattice.shape) + (lattice.n_neighbors,)
        if couplings.shape == expected_single:
            n_realizations = 1
        elif (
            len(couplings.shape) == len(expected_single) + 1
            and couplings.shape[1:] == expected_single
        ):
            n_realizations = couplings.shape[0]
        else:
            raise ValueError(
                f"couplings shape {list(couplings.shape)} does not match "
                f"lattice {list(expected_single)}"
            )
        coup_nd = couplings.reshape(
            n_realizations, lattice.n_spins, lattice.n_neighbors
        )
        temps = np.asarray(temperatures, dtype=np.float32)
        self.n_replicas = n_replicas
        self.n_temps = len(temps)
        self.n_realizations = int(n_realizations)
        self.constructor_seed = int(seed) if seed is not None else 42
        self.default_chunk = int(default_chunk)
        self.rt = Runtime.build(lattice, coup_nd, temps, n_replicas, self.device)
        self.state = None
        self._init_state(self.constructor_seed)

    # ----------------------------------------------------------------- state

    def _init_state(self, base_seed: int) -> None:
        """(Re-)initialize dynamics deterministically from ``base_seed``:
        random +-1 spins, identity PT permutation, zeroed PT diagnostics
        (realization.rs:155-210)."""
        rt = self.rt
        d, dev = rt.n_disorder, self.device
        base_keys = np.stack(
            [seedlib.key_from_u64(seedlib.realization_seed(base_seed, r))
             for r in range(d)]
        )
        spins = seedlib.initial_spins(base_keys, rt.n_systems, rt.n_spins)
        sid0 = torch.arange(rt.n_systems, dtype=torch.int32, device=dev)
        sid0 = sid0.reshape(1, rt.n_replicas, rt.n_temps).repeat(d, 1, 1)
        n_edges = max(rt.n_temps - 1, 0)
        i32 = dict(dtype=torch.int32, device=dev)
        self.state = {
            "spins": torch.from_numpy(spins).to(dev),
            "system_ids": sid0,
            "base_keys": base_keys,
            "counter": np.int32(0),
            "warmup": np.int32(0),
            "pt_edge_attempts": torch.zeros((d, n_edges), **i32),
            "pt_edge_acceptances": torch.zeros((d, n_edges), **i32),
            "pt_round_trips": torch.zeros((d, rt.n_systems), **i32),
            "pt_trip_state": init_trip_state(sid0, rt.hot_slot),
            "pt_parity": np.int32(0),
        }

    def save_checkpoint(self, path) -> None:
        not_ported("save_checkpoint", "4c")

    def load_checkpoint(self, path) -> None:
        not_ported("load_checkpoint", "4c")

    def get_spins(self) -> np.ndarray:
        """Flat int8 spins of the first realization (src/lib.rs:620-622)."""
        return self.state["spins"][0].cpu().numpy().reshape(-1)

    def reset(self, seed=None) -> None:
        """Deterministic re-initialization (src/lib.rs:624-633)."""
        base = int(seed) if seed is not None else self.constructor_seed
        self._init_state(base)

    # ---------------------------------------------------------------- sample

    def sample(
        self,
        n_sweeps,
        sweep_mode,
        cluster_update_interval=None,
        cluster_mode=None,
        cluster_action=None,
        pt_interval=None,
        pt_schedule=None,
        overlap_cluster_update_interval=None,
        overlap_cluster_build_mode=None,
        overlap_cluster_mode=None,
        overlap_cluster_action=None,
        warmup_ratio=None,
        collect_cluster_stats=None,
        autocorrelation_max_lag=None,
        autocorrelation_backend=None,
        sequential=None,
        equilibration_diagnostic=None,
        snapshot_interval=None,
        progress=None,
    ) -> dict:
        """Run the Monte Carlo loop; returns the raw results dict.

        Kwarg semantics and defaults mirror src/lib.rs:176-284; options
        outside the slice raise ``NotImplementedError``.
        """
        if overlap_cluster_update_interval is not None:
            not_ported("overlap cluster moves", "7")
        if snapshot_interval is not None:
            not_ported("snapshot_interval", "7")
        if autocorrelation_max_lag is not None:
            not_ported("autocorrelation_max_lag", "4b")
        if equilibration_diagnostic:
            not_ported("equilibration_diagnostic", "4b")
        n_sweeps = int(n_sweeps)
        warmup = warmup_ratio if warmup_ratio is not None else 0.25
        warmup_sweeps = int(np.floor(n_sweeps * float(warmup) + 0.5))
        cluster_update = None
        if cluster_update_interval is not None:
            action = parse_cluster_action(cluster_action or "update")
            cluster_update = ClusterUpdate(
                interval=int(cluster_update_interval),
                mode=parse_cluster_mode(cluster_mode or "sw"),
                action=action,
                collect_stats=bool(collect_cluster_stats) or action == "observe",
            )
        cfg = SimConfig(
            n_sweeps=n_sweeps,
            warmup_sweeps=warmup_sweeps,
            sweep_mode=parse_sweep_mode(sweep_mode),
            cluster_update=cluster_update,
            pt_interval=int(pt_interval) if pt_interval is not None else None,
            pt_schedule=parse_pt_schedule(pt_schedule or "single_random_edge"),
        )
        cfg.validate()
        if cluster_update is not None and cluster_update.action == "observe":
            not_ported("cluster_action='observe'", "6o")

        state = self.state
        state["warmup"] = np.int32(warmup_sweeps)
        acc = init_accumulators(self.rt, cfg)
        s = 0
        while s < n_sweeps:
            n = min(self.default_chunk, n_sweeps - s)
            with _defer_sigint():
                run_chunk(self.rt, cfg, state, acc, s, n)
            s += n
            if progress is not None:
                progress(s, n_sweeps)
        pt_state = None
        if cfg.pt_interval is not None:
            pt_state = {k: state[k].cpu().numpy() for k in (
                "pt_edge_attempts", "pt_edge_acceptances", "pt_round_trips")}
        fk_csd = acc["fk_csd"].cpu().numpy() if "fk_csd" in acc else None
        return finalize(acc["rec_sums"].cpu().numpy(), acc["n_recorded"],
                        self.rt.n_replicas, pt_state, fk_csd)
