"""Connected components of a batch of bond graphs on any lattice.

Counterpart of ``connected_components_batch`` (``peapods_tpu/ops/
pallas_cc_batch.py:428``, kernel ``_cc_batch_kernel`` :394, with offset
tables through ``cc_gen_offsets`` :332) and ``connected_components_2d``
(``peapods_tpu/ops/pallas_cc.py:66``): int32 labels ``[B, n]``, each site's
component's minimum site index, of bool masks ``[B, n, n_nb]`` whose entry
``[b, i, d]`` is the bond from site ``i`` to its neighbour at the lattice's
forward offset ``d``.

:func:`cc_labels` launches ``csrc/cc.cu``'s ``cc_link`` and ``cc_label`` on
CUDA tensors (counted in :data:`LAUNCHES`) and runs the plain version
:func:`~.cluster.connected_components` on CPU tensors.  The kernels read
the masks packed into one state byte a site (bit ``d``: bond ``d``) and a
parent array that starts as ``parent[i] = i``; the FK bonds of the staged
path (``fk.fk_staged``) write both and call :func:`launch` directly.
"""

from __future__ import annotations

import torch

from . import _build
from .cluster import connected_components
from .lattice import MAX_OFFSETS

__all__ = ["LAUNCHES", "cc_labels", "cc_labels_plain", "launch", "pack_masks"]

# kernel launches since the last reset, by kernel name
LAUNCHES = {"cc_link": 0, "cc_label": 0}


def cc_labels_plain(masks, lattice):
    """The plain version: the min-label fixed point on the lattice's
    offsets."""
    return connected_components(masks.to(torch.bool), lattice.shape, lattice.offsets)


def pack_masks(masks):
    """uint8 ``[..., n]`` state bytes of bool masks ``[..., n, n_nb]``: bit
    ``d`` is bond ``d``."""
    bits = torch.arange(masks.shape[-1], device=masks.device, dtype=torch.uint8)
    return (masks.to(torch.uint8) << bits).sum(-1, dtype=torch.uint8)


def launch(lib, stream, p_state, p_parent, p_labels, lattice, n_graphs):
    """Launch ``cc_link`` then ``cc_label`` on raw pointers: ``n_graphs``
    graphs of ``lattice`` whose state bytes hold the bonds and whose parents
    start as ``parent[i] = i``; the labels go to ``p_labels``."""
    _build.check(lib.peapods_cc_link(p_state, p_parent,
                                     lattice.kernel_geometry.ctypes.data, n_graphs,
                                     stream), "cc_link")
    LAUNCHES["cc_link"] += 1
    _build.check(lib.peapods_cc_label(p_parent, p_labels, lattice.n_spins, n_graphs,
                                      stream), "cc_label")
    LAUNCHES["cc_label"] += 1


def cc_labels(masks, lattice):
    """int32 ``[B, n]`` component labels of bool masks ``[B, n, n_nb]`` on
    ``lattice`` (any offsets, up to six): the plain version for CPU tensors,
    the two kernels for CUDA tensors."""
    if _build.device_kind(masks) == "cpu":
        return cc_labels_plain(masks, lattice)
    dev = masks.device
    b = masks.shape[0]
    n, n_nb = lattice.n_spins, lattice.n_neighbors
    _build.expect(masks, "masks", torch.bool, (b, n, n_nb), dev)
    if n_nb > MAX_OFFSETS:
        raise ValueError(f"at most {MAX_OFFSETS} offsets")
    if not 1 <= b <= 65535:
        raise ValueError("1 to 65535 graphs per call")
    state = pack_masks(masks)
    parent = torch.arange(n, dtype=torch.int32, device=dev).repeat(b, 1)
    labels = torch.empty((b, n), dtype=torch.int32, device=dev)
    launch(_build.library(), torch.cuda.current_stream(dev).cuda_stream,
           state.data_ptr(), parent.data_ptr(), labels.data_ptr(), lattice, b)
    return labels
