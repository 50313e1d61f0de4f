"""peapods_tpu_torch: the PyTorch / CUDA port of ``peapods_tpu``.

The port runs beside the JAX package and imports none of it.  Today it runs
Metropolis or Gibbs sweeps with parallel tempering, every sweep measured:
one replica on a 2D square lattice with even extents (the mega path), with
optional Swendsen-Wang or Wolff cluster updates (the per-sweep path); and
two replicas or more on a 2D square or 3D cubic lattice with even extents
(the replica path: the pair overlaps, PT on each replica's ladder, and the
Houdayer, Joerg and CMR overlap moves); and one replica on a lattice
split into row bands over a ``space`` mesh (``parallel.mesh.make_mesh``)
-- on an NVIDIA H100 through hand-written CUDA kernels (``device="cuda"``),
or on the CPU through their plain torch versions (``device="cpu"``).

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
