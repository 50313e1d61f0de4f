"""IsingSimulation: the stateful engine behind the port's ``Ising``.

Counterpart of ``peapods_tpu/engine/simulation.py`` (:75-436) for the slice
the port runs today, Metropolis or Gibbs sweeps with optional parallel
tempering (both schedules), every sweep measured, on lattices of any
dimension and extents >= 1 with up to 32 forward offsets, on four paths:

* one replica on a 2D square lattice with even extents: the mega path, or
  the per-sweep path with an FK cluster phase: SW or Wolff updates (with
  or without cluster statistics), or SW observe
  (``cluster_action="observe"``: the graph observations, with the winding
  flags when the lattice was built without explicit offsets);
* one replica on any other lattice (triangular, BCC, FCC, 3D cubic, odd
  extents, a 1D chain, 4D and up, an offset table of up to 32
  ``neighbor_offsets``): the per-sweep path, with the same FK phases (off
  the square, cubic and triangular lattices with even extents through the
  staged path: bonds, the connected-components kernels, flips; past three
  dimensions or six offsets in the kernels' table form);
* two replicas or more on a 2D square or 3D cubic lattice with even
  extents: the replica path, with the pair overlaps q and q_l, PT on each
  replica's ladder and
  the overlap moves (Houdayer(N), Joerg, CMR; Wolff or SW; in round
  robin), with or without their cluster statistics, or observed (SW:
  the graph observations of each move kind, winding on the canonical 2D
  square; the spins untouched);
* two replicas or more with an FK phase, with ``snapshot_interval``, or on
  any other lattice of up to 32 offsets: the per-sweep path with the pair
  overlaps over the lattice's offsets, PT on each replica's ladder, and
  the overlap moves with their statistics, observations and snapshots
  (``cluster_snapshots``); past three dimensions or six offsets (the 4D
  +-J glass) the pair overlaps and the moves in the kernels' table form;
* one replica on a ``space`` mesh (:func:`~peapods_tpu_torch.parallel.mesh.
  make_mesh` with the axis ``("space",)``; the mesh may name one card for
  every band): the per-sweep path over the lattice's row bands, on every
  2D or 3D lattice with even extents and up to six offsets, with the same
  sweeps, PT and FK updates, bitwise the unsharded per-sweep path.

The device is explicit (``device="cuda"`` by default); a CUDA device runs
the hand-written kernels, ``device="cpu"`` their plain torch versions, and
nothing ever falls back from one to the other.

``state`` has the reference's keys: ``spins`` int8 ``[d, n_systems,
n_spins]`` stored by system on the device (on a space mesh ``bands``
instead: each band's window ``[d, n_systems, n_window]`` on its device),
``system_ids`` int32 ``[d, R, T]``, the PT counters, and on the host
``base_keys`` (uint32 ``[d, 2]`` threefry key data), ``counter``,
``warmup`` and ``pt_parity``.

Every path folds the autocorrelation series and the equilibration
diagnostic when ``sample`` asks for them (``engine/loop.py``
``_fold_series``), and the state round-trips through the reference's
checkpoint file (``save_checkpoint`` / ``load_checkpoint``, through
:mod:`~peapods_tpu_torch.engine.convert`).
"""

from __future__ import annotations

import contextlib
import signal
import sys
import threading

import numpy as np
import torch

from ..ops.halo import gather_band_spins
from ..ops.lattice import Lattice
from ..ops.tempering import init_trip_state
from ..parallel.mesh import Mesh, auto_mesh
from ..utils.progress import ProgressPrinter
from . import convert
from . import seeds as seedlib
from .config import (
    ClusterUpdate,
    OverlapClusterConfig,
    SimConfig,
    not_ported,
    parse_cluster_action,
    parse_ac_backend,
    parse_cluster_mode,
    parse_overlap_modes,
    parse_pt_schedule,
    parse_sweep_mode,
)
from .loop import Runtime, SpaceRuntime, init_accumulators, run_chunk
from .records import link_bonds
from .results import autocorr_streams, equil_snaps, finalize

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


def _snapshot_entry(snap: dict) -> dict:
    """A snapshot in the reference's form (``HostAccum.add_snapshot``,
    peapods_tpu/engine/results.py:228-240): realization 0's first group at
    each temperature, ``cluster_ids`` uint32 ``[T, n]`` (CMR's grey
    labels), ``spins`` int8 ``[T, 2, n]`` before the move, ``system_ids``
    uint64 ``[T, 2]``, and CMR's ``blue_ids`` uint32 ``[T, n]``."""
    entry = {
        "sweep_id": int(snap["sweep_id"]),
        "mode_idx": int(snap["mode_idx"]),
        "cluster_ids": snap["cluster_ids"].cpu().numpy().astype(np.uint32),
        "spins": snap["spins"].cpu().numpy().astype(np.int8),
        "system_ids": snap["system_ids"].cpu().numpy().astype(np.uint64),
    }
    if "blue_ids" in snap:
        entry["blue_ids"] = snap["blue_ids"].cpu().numpy().astype(np.uint32)
    return entry


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
        if isinstance(mesh, str) and mesh == "auto":
            mesh = auto_mesh(None)
        if mesh is not None and not isinstance(mesh, Mesh):
            not_ported(f"a device mesh of type {type(mesh).__name__}", "9")
        if mesh is not None and mesh.axis_names != ("space",):
            not_ported(f"a mesh with the axes {list(mesh.axis_names)} (only "
                       "('space',) runs)", "9")
        n_replicas = int(n_replicas) if n_replicas is not None else 1
        lattice = Lattice(lattice_shape, neighbor_offsets)
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.lattice = lattice
        self.device = resolve_device(device)
        self.mesh = mesh
        band_devices = None
        if mesh is not None:
            if any(x.type != self.device.type for x in mesh.devices):
                raise ValueError(f"device={device!r} does not name the mesh's "
                                 f"devices {[str(x) for x in mesh.devices]}")
            band_devices = [resolve_device(x) for x in mesh.devices]
            self.device = band_devices[0]
            if n_replicas > 1:
                not_ported("replicas on a space mesh", "9")
            if (lattice.table or lattice.n_dims == 1
                    or any(x % 2 for x in lattice.shape)):
                not_ported(f"the lattice {list(lattice.shape)} of {lattice.n_neighbors} "
                           "offsets on a space mesh", "9")

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
        space = (None if band_devices is None
                 else SpaceRuntime.build(lattice, coup_nd, band_devices))
        self.rt = Runtime.build(lattice, coup_nd, temps, n_replicas, self.device,
                                space=space)
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
        spins = seedlib.initial_spins(base_keys, rt.n_systems, rt.n_spins, device=dev)
        sid0 = torch.arange(rt.n_systems, dtype=torch.int32, device=dev)
        sid0 = sid0.reshape(1, rt.n_replicas, rt.n_temps).repeat(d, 1, 1)
        n_edges = max(rt.n_temps - 1, 0)
        i32 = dict(dtype=torch.int32, device=dev)
        self.state = {
            **({"spins": spins} if rt.space is None
               else {"bands": rt.space.windows(spins)}),
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
        """Write the dynamics state to an ``.npz`` file in the reference's
        form (peapods_tpu/engine/simulation.py:213-227): its state keys,
        ``__constructor_seed`` and ``__key_data``; on a space mesh the
        spins gathered from the bands.  Either engine loads it."""
        state = dict(self.state)
        if self.rt.space is not None:
            del state["bands"]
            state["spins"] = self.all_spins()
        convert.write_checkpoint(path, convert.to_reference(state),
                                 self.constructor_seed)

    def load_checkpoint(self, path) -> None:
        """Restore a state written by :meth:`save_checkpoint` (or by the
        reference engine) for this constructor seed (peapods_tpu/engine/
        simulation.py:229-250); on a space mesh the spins are split into
        the bands again."""
        ref, seed = convert.read_checkpoint(path)
        if seed != self.constructor_seed:
            raise ValueError(
                f"checkpoint was written for constructor seed {seed}, "
                f"this simulation uses {self.constructor_seed}"
            )
        rt = self.rt
        want = {k: tuple(v.shape) for k, v in self.state.items() if torch.is_tensor(v)}
        want.update(spins=(rt.n_disorder, rt.n_systems, rt.n_spins),
                    base_keys=(rt.n_disorder, 2))
        for k, shape in want.items():
            if np.shape(ref[k]) != shape:
                raise ValueError(f"checkpoint entry {k} has shape "
                                 f"{list(np.shape(ref[k]))}, this simulation's "
                                 f"{list(shape)}")
        state = convert.from_reference(ref, self.device)
        if self.rt.space is not None:
            state["bands"] = self.rt.space.windows(state.pop("spins"))
        self.state = state

    def all_spins(self):
        """int8 ``[d, n_systems, n_spins]`` spins by system on the device (on
        a space mesh gathered from the bands onto the first band's)."""
        if self.rt.space is None:
            return self.state["spins"]
        return gather_band_spins(self.state["bands"], self.rt.space.bands)

    def get_spins(self) -> np.ndarray:
        """Flat int8 spins of the first realization (src/lib.rs:620-622)."""
        return self.all_spins()[0].cpu().numpy().reshape(-1)

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
        outside the slice raise ``NotImplementedError``.  ``progress(done,
        total)`` is called after every chunk; left ``None``, a
        :class:`~peapods_tpu_torch.utils.progress.ProgressPrinter` reports
        when stderr is a terminal.  Ctrl-C is held until the chunk in flight
        is done, so an interrupt leaves the state at the last whole chunk.
        """
        ac_backend = parse_ac_backend(autocorrelation_backend or "ring")
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
        overlap_cluster = None
        if overlap_cluster_update_interval is not None:
            action = parse_cluster_action(overlap_cluster_action or "update")
            overlap_cluster = OverlapClusterConfig(
                interval=int(overlap_cluster_update_interval),
                modes=parse_overlap_modes(overlap_cluster_build_mode or "houdayer"),
                cluster_mode=parse_cluster_mode(overlap_cluster_mode or "wolff"),
                action=action,
                collect_stats=bool(collect_cluster_stats) or action == "observe",
                snapshot_interval=snapshot_interval,
            )
        cfg = SimConfig(
            n_sweeps=n_sweeps,
            warmup_sweeps=warmup_sweeps,
            sweep_mode=parse_sweep_mode(sweep_mode),
            cluster_update=cluster_update,
            pt_interval=int(pt_interval) if pt_interval is not None else None,
            pt_schedule=parse_pt_schedule(pt_schedule or "single_random_edge"),
            overlap_cluster=overlap_cluster,
            autocorrelation_max_lag=(int(autocorrelation_max_lag)
                                     if autocorrelation_max_lag is not None else None),
            autocorrelation_backend=ac_backend,
            equilibration_diagnostic=bool(equilibration_diagnostic),
        )
        cfg.validate()
        h = overlap_cluster
        if h is not None and self.n_replicas < h.max_group_size():
            raise ValueError(
                "overlap cluster requires n_replicas >= max group_size "
                f"({self.n_replicas} < {h.max_group_size()})"
            )
        if self.rt.space is not None:
            if snapshot_interval is not None:
                not_ported("snapshot_interval on a space mesh", "9")
            if cluster_update is not None and cluster_update.action == "observe":
                not_ported('cluster_action="observe" on a space mesh', "9")
            if (cluster_update is not None
                    and self.rt.space.geometry.halo > 1):
                not_ported("an FK phase on offsets that reach more than one row "
                           "on a space mesh", "9")

        state = self.state
        state["warmup"] = np.int32(warmup_sweeps)
        acc = init_accumulators(self.rt, cfg)
        if progress is None and sys.stderr.isatty():
            progress = ProgressPrinter()
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
        fk_obs = None
        if "fk_obs" in acc:
            fk_obs = dict(sums=acc["fk_obs"].cpu().numpy(), n_spins=self.rt.n_spins,
                          n_neighbors=self.lattice.n_neighbors,
                          with_winding=self.lattice.canonical_square)
        overlap = None
        if "overlap_csd" in acc:
            rt = self.rt
            overlap = {k: acc[k].cpu().numpy() for k in (
                "overlap_csd", "top4_sum", "top4_n")}
            overlap.update(
                kinds=[m.kind for m in h.modes], n_pairs=rt.n_pairs,
                obs={k[len("ov_obs_"):]: acc[k].cpu().numpy() for k in acc
                     if k.startswith("ov_obs_")},
                n_spins=rt.n_spins, n_neighbors=self.lattice.n_neighbors,
                with_winding=self.lattice.canonical_square)
        if "winding_errors" in acc and int(acc["winding_errors"].item()):
            raise RuntimeError("the winding kernel could not settle a graph: "
                               "its labels do not belong to its bond masks")
        pairs = None
        if "q_hist" in acc:
            pairs = {k: acc[k].cpu().numpy() for k in ("q_hist", "ql_at_q", "ql2_at_q")}
            pairs.update(n_pairs=self.rt.n_pairs, n_bonds=link_bonds(self.lattice))
        snapshots = [_snapshot_entry(x) for x in acc.get("snapshots", [])]
        return finalize(acc["rec_sums"].cpu().numpy(), acc["n_recorded"],
                        self.rt.n_replicas, pt_state, fk_csd, pairs, fk_obs, overlap,
                        snapshots, autocorr_streams(acc, self.rt.n_disorder,
                                                    self.rt.n_temps),
                        equil_snaps(acc, n_sweeps))
