"""FK observe's winding flags of a batch of 2D square bond graphs.

Counterpart of ``winding_batch`` (``peapods_tpu/ops/pallas_cc_batch.py:572``,
kernel ``_winding_kernel`` :501): per graph, does any component wrap the
torus along axis 0 (``wx``) / axis 1 (``wy``), from bool masks ``[B, n, 2]``
(bonds to ``(r+1, c)`` and ``(r, c+1)``) and their component labels
``[B, n]`` (each component's minimum site index).

:func:`winding_flags` launches ``csrc/winding.cu`` on CUDA tensors (counted
in :data:`LAUNCHES`) and runs the plain version
:func:`~.cluster.winding_flags` on CPU tensors.  The graphs are not packed
into tiles, so a batch of any size is whole (the reference truncates one
that is not a multiple of its tile).
"""

from __future__ import annotations

import torch

from . import _build
from .cluster import winding_flags as winding_flags_plain

__all__ = ["LAUNCHES", "winding_flags", "winding_flags_plain"]

# kernel launches since the last reset, by kernel name
LAUNCHES = {"winding": 0}


def winding_flags(masks, labels, shape, *, errors=None):
    """bool ``(wx, wy) [B]`` of masks bool ``[B, n, 2]`` and labels int32
    ``[B, n]`` on the 2D square lattice ``shape``.

    On CUDA tensors the kernel marks graphs whose labels do not belong to
    their masks (sites it cannot settle).  With ``errors`` ``None`` the
    wrapper reads the mark (a host synchronisation) and raises
    ``ValueError``; otherwise the mark is or-ed into ``errors`` (int32
    ``[1]`` on the device) for the caller to check later, as the engine
    does once a chunk.  The plain version raises at once.
    """
    if _build.device_kind(masks) == "cpu":
        return winding_flags_plain(masks, labels, shape)
    dev = masks.device
    if len(shape) != 2:
        raise ValueError("winding flags are defined on 2D square lattices")
    l0, l1 = (int(s) for s in shape)
    b, n = labels.shape[0], l0 * l1
    _build.expect(masks, "masks", torch.bool, (b, n, 2), dev)
    _build.expect(labels, "labels", torch.int32, (b, n), dev)
    lib = _build.library()
    if n > lib.peapods_winding_max_sites():
        raise ValueError(f"{n} sites: a graph must fit one block "
                         f"({lib.peapods_winding_max_sites()} sites)")
    check = errors is None
    if check:
        errors = torch.zeros(1, dtype=torch.int32, device=dev)
    _build.expect(errors, "errors", torch.int32, (1,), dev)
    out = torch.zeros(b, dtype=torch.uint8, device=dev)
    disp = torch.empty((b, n), dtype=torch.int64, device=dev)
    queue = torch.empty((b, n), dtype=torch.int32, device=dev)
    if b:
        _build.check(lib.peapods_winding(
            masks.data_ptr(), labels.data_ptr(), disp.data_ptr(), queue.data_ptr(),
            out.data_ptr(), errors.data_ptr(), b, l0, l1,
            torch.cuda.current_stream(dev).cuda_stream), "winding")
        LAUNCHES["winding"] += 1
    if check and int(errors.item()):
        raise ValueError("winding: sites left unsettled, the labels do not belong "
                         "to the bond masks")
    return (out & 1) != 0, (out & 2) != 0
