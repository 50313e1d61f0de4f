"""Public ``Ising`` model class of the port.

Counterpart of ``peapods_tpu/models/ising.py``: the same constructor and
``sample`` signatures (plus ``device=``), the same seed discipline
(independent SeedSequence streams for couplings and dynamics), coupling
synthesis and derived observables, for the slice the port runs today (see
:mod:`peapods_tpu_torch.engine.simulation`).
"""

from __future__ import annotations

import numpy as np

from ..engine.config import not_ported
from ..engine.seeds import dynamics_seed, seed_material

__all__ = ["Ising"]

_COUPLING_MODES = ("ferro", "bimodal", "gaussian")

# sample() kwarg validation, as the reference checks it before any state
# changes (spin_models.py:222-247)
_SAMPLE_ENUMS = (
    ("cluster_action", ("update", "observe")),
    ("overlap_cluster_action", ("update", "observe")),
    ("pt_schedule", ("single_random_edge", "full_ladder")),
    ("autocorrelation_backend", ("ring", "fft")),
)
_SAMPLE_REQUIRES = (
    ("autocorrelation_backend", "fft", "autocorrelation_max_lag"),
    ("cluster_action", "observe", "cluster_update_interval"),
    ("overlap_cluster_action", "observe", "overlap_cluster_update_interval"),
)
_SAMPLE_GATES = (
    ("cluster_mode", "cluster_update_interval"),
    ("cluster_action", "cluster_update_interval"),
    ("overlap_cluster_build_mode", "overlap_cluster_update_interval"),
    ("overlap_cluster_mode", "overlap_cluster_update_interval"),
    ("overlap_cluster_action", "overlap_cluster_update_interval"),
    ("snapshot_interval", "overlap_cluster_update_interval"),
)


def _synthesize_couplings(mode, coupling_seed, n_disorder, single_shape):
    """Per-disorder coupling arrays from independent SeedSequence children
    (peapods_tpu/models/ising.py:65-79)."""
    if mode not in _COUPLING_MODES:
        raise ValueError("Invalid mode for couplings.")
    samples = []
    for child in coupling_seed.spawn(n_disorder):
        rng = np.random.default_rng(child)
        if mode == "ferro":
            j = np.ones(single_shape, dtype=np.float32)
        elif mode == "bimodal":
            j = (2 * rng.integers(0, 2, size=single_shape) - 1).astype(np.float32)
        else:  # gaussian
            j = rng.standard_normal(single_shape).astype(np.float32)
        samples.append(j)
    return samples[0] if n_disorder == 1 else np.stack(samples)


class Ising:
    """Ising model on a periodic 2D square lattice with Monte Carlo
    sampling on a torch device.

    After `sample`, the derived observables ``binder_cumulant`` and
    ``heat_capacity`` live on the instance beside the raw moments.
    """

    def __init__(
        self,
        lattice_shape,
        couplings="ferro",
        temperatures=np.geomspace(0.1, 10, 32),
        n_replicas=1,
        n_disorder=1,
        neighbor_offsets=None,
        geometry=None,
        seed=None,
        device="cuda",
    ):
        """Create an Ising model.

        Args:
            lattice_shape: periodic lattice extents ``(H, W)``, both even.
            couplings: ``"ferro"`` (all +1), ``"bimodal"`` (random +-1),
                ``"gaussian"`` (standard normal), or an explicit array of
                shape ``(H, W, 2)`` (optionally with a leading
                ``n_disorder`` axis).
            temperatures: temperature grid for the ladder.
            n_replicas: replicas per temperature (1 in this port).
            n_disorder: number of coupling realizations.
            seed: non-negative integer controlling both coupling synthesis
                and the dynamics; ``None`` draws fresh entropy.
            device: ``"cuda"`` (the CUDA kernels) or ``"cpu"`` (their plain
                torch versions).
        """
        from ..engine.simulation import IsingSimulation

        if geometry is not None or neighbor_offsets is not None:
            not_ported("geometry / neighbor_offsets (non-square lattices)", "4a")
        self.lattice_shape = tuple(lattice_shape)
        self.n_spins = int(np.prod(lattice_shape))
        self.n_dims = len(lattice_shape)
        self.n_neighbors = self.n_dims
        self.temperatures = np.asarray(temperatures).copy().astype(np.float32)
        self.n_temps = len(temperatures)
        self.n_replicas = n_replicas
        self.n_disorder = n_disorder
        self.seed = seed
        coupling_seed, self._constructor_dynamics_seed = seed_material(seed)

        if isinstance(couplings, np.ndarray):
            self.couplings = couplings.astype(np.float32)
        else:
            self.couplings = _synthesize_couplings(
                couplings,
                coupling_seed,
                n_disorder,
                self.lattice_shape + (self.n_neighbors,),
            )

        self._sim = IsingSimulation(
            list(lattice_shape),
            self.couplings,
            self.temperatures,
            n_replicas,
            None,
            self._constructor_dynamics_seed,
            device=device,
        )

    def reset(self, seed=None):
        """Reset dynamics while keeping the couplings fixed."""
        self._sim.reset(None if seed is None else dynamics_seed(seed))

    def sample(
        self,
        n_sweeps,
        sweep_mode="metropolis",
        cluster_update_interval=None,
        cluster_mode="sw",
        cluster_action="update",
        pt_interval=None,
        pt_schedule="single_random_edge",
        overlap_cluster_update_interval=None,
        overlap_cluster_build_mode="houdayer",
        overlap_cluster_mode="wolff",
        overlap_cluster_action="update",
        warmup_ratio=0.25,
        collect_cluster_stats=False,
        autocorrelation_max_lag=None,
        autocorrelation_backend="ring",
        sequential=False,
        equilibration_diagnostic=False,
        snapshot_interval=None,
    ):
        """Run Monte Carlo sampling and compute observables (the reference
        semantics, spin_models.py:146-269).  Returns the raw results dict."""
        kw = dict(
            cluster_update_interval=cluster_update_interval,
            cluster_mode=cluster_mode,
            cluster_action=cluster_action,
            pt_interval=pt_interval,
            pt_schedule=pt_schedule,
            overlap_cluster_update_interval=overlap_cluster_update_interval,
            overlap_cluster_build_mode=overlap_cluster_build_mode,
            overlap_cluster_mode=overlap_cluster_mode,
            overlap_cluster_action=overlap_cluster_action,
            warmup_ratio=warmup_ratio,
            collect_cluster_stats=collect_cluster_stats,
            autocorrelation_max_lag=autocorrelation_max_lag,
            autocorrelation_backend=autocorrelation_backend,
            sequential=sequential,
            equilibration_diagnostic=equilibration_diagnostic,
            snapshot_interval=snapshot_interval,
        )
        for name, choices in _SAMPLE_ENUMS:
            if kw[name] not in choices:
                raise ValueError(
                    f"{name} must be " + " or ".join(f"'{c}'" for c in choices)
                )
        for name, value, needed in _SAMPLE_REQUIRES:
            if kw[name] == value and kw[needed] is None:
                raise ValueError(f"{name}='{value}' requires {needed}")
        for name, interval in _SAMPLE_GATES:
            if not kw[interval]:
                kw[name] = None

        result = self._sim.sample(n_sweeps, sweep_mode, **kw)
        self._attach_observables(result)
        return result

    def _attach_observables(self, result):
        """Derived quantities (spin_models.py:270-335)."""
        self.mags = result["mags"]
        self.mags2 = result["mags2"]
        self.mags4 = result["mags4"]
        self.energies_avg = result["energies"]
        self.energies2_avg = result["energies2"]
        with np.errstate(divide="ignore", invalid="ignore"):
            self.binder_cumulant = 1 - self.mags4 / (3 * self.mags2**2)
        self.heat_capacity = (
            self.n_spins
            * (self.energies2_avg - self.energies_avg**2)
            / self.temperatures**2
        )
        if "fk_csd" in result:
            self.fk_csd = result["fk_csd"]
            self.mean_cluster_size = np.array(
                [self._mean_cluster_size(h) for h in self.fk_csd]
            )
        self.per_disorder = result.get("per_disorder", {})

    @staticmethod
    def _mean_cluster_size(hist):
        """Site-weighted mean cluster size from a CSD histogram."""
        sizes = np.arange(len(hist))
        site_weights = sizes * hist
        n_sites = site_weights.sum()
        return (sizes * site_weights).sum() / n_sites if n_sites > 0 else 0.0

    def save_checkpoint(self, path):
        self._sim.save_checkpoint(path)

    def load_checkpoint(self, path):
        self._sim.load_checkpoint(path)

    def get_energies(self):
        """Mean energies per temperature from the last `sample` run."""
        return self.energies_avg
