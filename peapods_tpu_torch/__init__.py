"""peapods_tpu_torch: the PyTorch / CUDA port of ``peapods_tpu``.

The port runs beside the JAX package and imports none of it.  It runs
Metropolis or Gibbs sweeps with parallel tempering, every sweep measured,
on periodic lattices of any dimension and extents >= 1 (1D chains, the 2D
square and triangular lattices, 3D cubic, BCC and FCC, 4D and up, and
offset tables of up to 32 ``neighbor_offsets``), with optional
Swendsen-Wang or Wolff cluster updates or SW observe; with two replicas or
more, on lattices of up to three dimensions and six offsets, the pair
overlaps, PT on each replica's ladder and the Houdayer(N), Joerg and CMR
overlap moves with their statistics, observations and snapshots; the
autocorrelation times, the equilibration diagnostic and checkpoints that
either engine reads; and one replica split into row bands over a ``space``
mesh (``parallel.mesh.make_mesh``).  It runs on an NVIDIA H100 through
hand-written CUDA kernels (``device="cuda"``, the default) or on the CPU
through their plain torch versions (``device="cpu"``).

The Python layer is the JAX package's: :class:`Ising`, :func:`run_sweep`
(``sweep.py``, with its ``.npz`` files and plots) and the command line
``peapods-torch simulate | bench | sweep`` (``python -m
peapods_tpu_torch.cli``, with ``--device``).

Importing the package is cheap; torch is imported with the first use of
``Ising``, ``IsingSimulation`` or ``run_sweep``.
"""

__all__ = ["Ising", "IsingSimulation", "run_sweep"]


def __getattr__(name):
    if name == "Ising":
        from .models.ising import Ising

        return Ising
    if name == "IsingSimulation":
        from .engine.simulation import IsingSimulation

        return IsingSimulation
    if name == "run_sweep":
        from .sweep import run_sweep

        return run_sweep
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
