"""peapods_tpu_torch: the PyTorch / CUDA port of ``peapods_tpu``.

The port runs beside the JAX package and imports none of it.  Today it runs
a 2D square lattice with even extents and one replica: Metropolis or Gibbs
sweeps, parallel tempering, every sweep measured (the mega path), and
optional Swendsen-Wang or Wolff cluster updates (the per-sweep path) -- on
an NVIDIA H100 through hand-written CUDA kernels (``device="cuda"``), or on
the CPU through their plain torch versions (``device="cpu"``).

Importing the package is cheap; torch is imported with the first use of
``Ising`` or ``IsingSimulation``.
"""

__all__ = ["Ising", "IsingSimulation"]


def __getattr__(name):
    if name == "Ising":
        from .models.ising import Ising

        return Ising
    if name == "IsingSimulation":
        from .engine.simulation import IsingSimulation

        return IsingSimulation
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
