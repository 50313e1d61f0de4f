"""Device meshes of the port: which device holds each shard.

Counterpart of ``peapods_tpu/parallel/mesh.py`` (:31-131).  A
:class:`Mesh` names its axes and lists one torch device per shard, in
shard order; unlike a JAX mesh it may name one device several times, so
that four row bands of a lattice can live on one card and still exchange
real halo copies.  The port runs one axis today, ``"space"``: the lattice's
leading axis split into contiguous row bands
(:mod:`peapods_tpu_torch.engine.loop` ``run_chunk_space``).
:func:`make_mesh` builds meshes of one axis; the engine refuses a
``"disorder"`` or ``"systems"`` axis.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..engine.config import not_ported

__all__ = ["Mesh", "make_mesh", "auto_mesh"]


@dataclass(frozen=True)
class Mesh:
    """Axis names, extents and the device of every shard."""

    axis_names: tuple
    extents: tuple
    devices: tuple

    @property
    def shape(self) -> dict:
        """``{axis name: extent}``, as a JAX mesh reports it."""
        return dict(zip(self.axis_names, self.extents))


def make_mesh(n_devices=None, axis_names=("disorder",), devices=None) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (default: every
    CUDA device torch sees).  ``devices`` may repeat a device.  The one
    axis takes them all; meshes of several axes are not ported."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(x) for x in devices]
    if n_devices is not None:
        if int(n_devices) > len(devs):
            raise ValueError(f"{n_devices} devices asked for, {len(devs)} given")
        devs = devs[: int(n_devices)]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    axis_names = tuple(axis_names)
    if len(axis_names) != 1:
        not_ported(f"a mesh with the axes {list(axis_names)}", "9")
    return Mesh(axis_names, (len(devs),), tuple(devs))


def auto_mesh(n_disorder):
    """The mesh ``mesh="auto"`` takes: none, until the disorder axis is
    ported, so the port runs unsharded on any machine."""
    del n_disorder
    return None
