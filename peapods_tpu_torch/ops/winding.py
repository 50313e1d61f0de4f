"""FK observe's winding flags of a batch of 2D square bond graphs.

Counterpart of ``winding_batch`` (``peapods_tpu/ops/pallas_cc_batch.py:572``,
kernel ``_winding_kernel`` :501): per graph, does any component wrap the
torus along axis 0 (``wx``) / axis 1 (``wy``), from bool masks ``[B, n, 2]``
(bonds to ``(r+1, c)`` and ``(r, c+1)``) and their component labels
``[B, n]`` (each component's minimum site index).

:func:`winding_flags` launches the kernels of ``csrc/winding.cu`` on CUDA
tensors (counted in :data:`LAUNCHES`) and runs the plain version
:func:`~.cluster.winding_flags` on CPU tensors.  The kernels read the flags
from the wrap bonds of the open graph, the bond graph less its wrap bonds
(:func:`open_masks`), whose cycles never wind: its components
(:func:`winding_border_plain`) are contracted to nodes, each active wrap
bond moves the sheet by one along its axis, and a graph winds along an
axis iff a spanning-forest potential of sheets on that small graph
disagrees with a wrap bond (:func:`winding_wrap_plain`).  A graph that fits
one CTA (:func:`~.fk.link_plan`'s whole-graph form) takes one launch,
``winding``; a larger one four: ``winding_link`` (the open graph in boxes,
:func:`winding_link_plain`), ``winding_border``, ``winding_wrap`` and
``winding_check`` (:func:`winding_check_plain`).  :func:`winding_flags_open`
is that decomposition in plain torch.  The graphs are not packed into
tiles, so a batch of any size is whole (the reference truncates one that is
not a multiple of its tile).
"""

from __future__ import annotations

import torch

from . import _build
from .cluster import connected_components
from .cluster import winding_flags as winding_flags_plain
from .fk import (fk_link_flatten_plain, fk_link_plain, fk_link_tiles_plain, link_plan,
                 tile_bonds)

__all__ = ["LAUNCHES", "MAX_EXTENT", "winding_flags", "winding_flags_plain",
           "winding_plan", "winding_launches", "launch_winding", "open_masks", "winding_link_plain",
           "winding_border_plain", "winding_border_unions", "winding_wrap_plain",
           "winding_check_plain", "winding_flags_open"]

# kernel launches since the last reset, by kernel name
LAUNCHES = {"winding": 0, "winding_link": 0, "winding_border": 0, "winding_wrap": 0,
            "winding_check": 0}
TILED = ("winding_link", "winding_border", "winding_wrap", "winding_check")
# the largest extent the kernels take (csrc/winding.cu kMaxExtent): a sheet
# offset along one axis sums at most the other extent's wrap bonds, so kept
# mod 2**16 it stays exact while L0 and L1 are each below 2**15
MAX_EXTENT = 2**15 - 1


def winding_plan(shape, n_graphs: int):
    """The kernels' form for ``n_graphs`` graphs of ``shape``: the labelling's
    :class:`~.fk.LinkPlan` (its boxes and threads; ``tiled`` for four
    launches)."""
    l0, l1 = (int(s) for s in shape)
    return link_plan((l0, l1, 1), n_graphs)


def winding_launches(shape, n_graphs: int) -> dict:
    """The launches of one :func:`winding_flags` call on ``n_graphs`` graphs
    of ``shape``, by kernel name."""
    return dict.fromkeys(TILED if winding_plan(shape, n_graphs).tiled else ("winding",), 1)


def winding_flags(masks, labels, shape, *, errors=None):
    """bool ``(wx, wy) [B]`` of masks bool ``[B, n, 2]`` and labels int32
    ``[B, n]`` on the 2D square lattice ``shape``.

    On CUDA tensors the kernels mark graphs whose labels do not belong to
    their masks (a component with no site labelled as itself, where the
    plain version raises).  With ``errors`` ``None`` the wrapper reads the
    mark (a host synchronisation) and raises ``ValueError``; otherwise the
    mark is or-ed into ``errors`` (int32 ``[1]`` on the device) for the
    caller to check later, as the engine does once a chunk.  The plain
    version raises at once.
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
    if not (2 <= l0 <= MAX_EXTENT and 2 <= l1 <= MAX_EXTENT):
        raise ValueError(f"a {l0}x{l1} graph: the winding kernels take extents 2 to "
                         f"{MAX_EXTENT}")
    if b > 65535:
        raise ValueError("at most 65535 graphs per call")
    check = errors is None
    if check:
        errors = torch.zeros(1, dtype=torch.int32, device=dev)
    _build.expect(errors, "errors", torch.int32, (1,), dev)
    out = torch.empty(b, dtype=torch.uint8, device=dev)
    if b:
        launch_winding(_build.library(), torch.cuda.current_stream(dev).cuda_stream,
                       masks, labels, out, errors, (l0, l1))
    if check and int(errors.item()):
        raise ValueError("winding: sites left unsettled, the labels do not belong "
                         "to the bond masks")
    return (out & 1) != 0, (out & 2) != 0


def launch_winding(lib, stream, masks, labels, out, errors, shape):
    """Launch the winding kernels of ``lib`` (:func:`winding_plan`'s form)
    on checked tensors: masks bool ``[B, n, 2]`` and labels int32 ``[B, n]``
    of ``shape`` in, the flags into ``out`` uint8 ``[B]`` (bit 0: x, bit 1:
    y), the error mark or-ed into ``errors``."""
    l0, l1 = shape
    b = labels.shape[0]
    plan = winding_plan(shape, b)
    pm, pl, po, pe = masks.data_ptr(), labels.data_ptr(), out.data_ptr(), errors.data_ptr()
    if not plan.tiled:
        _build.check(lib.peapods_winding(pm, pl, po, pe, b, l0, l1, plan.threads, stream),
                     "winding")
        LAUNCHES["winding"] += 1
        return
    t0, t1, _ = plan.tile
    # one scratch allocation: W (int64 [B, n]), the parents (int32 [B, n]),
    # the counts (int32 [B, 3]), each written before it is read
    bn = b * l0 * l1
    scratch = torch.empty(bn + (bn + 3 * b + 1) // 2, dtype=torch.int64, device=masks.device)
    pw = scratch.data_ptr()
    pp = pw + 8 * bn
    pc = pp + 4 * bn
    for name, args in (
            ("winding_link", (pm, pp, pw, pc, b, l0, l1, t0, t1, plan.threads)),
            ("winding_border", (pm, pp, b, l0, l1, t0, t1)),
            ("winding_wrap", (pm, pp, pw, po, b, l0, l1)),
            ("winding_check", (pl, pp, pw, pc, pe, b, l0, l1))):
        _build.check(getattr(lib, f"peapods_{name}")(*args, stream), name)
        LAUNCHES[name] += 1


# ------------------------------------------------ the decomposition, plain


def open_masks(masks, shape):
    """bool ``[B, n, 2]``: the masks less the wrap bonds (the last row's
    bonds to row 0, the last column's to column 0)."""
    l0, l1 = shape
    keep = torch.ones((l0, l1, 2), dtype=torch.bool, device=masks.device)
    keep[-1, :, 0] = False
    keep[:, -1, 1] = False
    return masks & keep.view(1, l0 * l1, 2)


def winding_link_plain(masks, shape, tile):
    """Plain version of ``winding_link``: int32 ``[B, n]``, each site's
    parent the minimum site of its open component inside its box of
    ``tile = (t0, t1, 1)`` sites."""
    return fk_link_tiles_plain(open_masks(masks, shape), tuple(shape), tuple(tile))


def winding_border_plain(masks, shape):
    """The labels that ``winding_border``'s parents lead to: int32 ``[B,
    n]``, each open component's minimum site."""
    return fk_link_plain(open_masks(masks, shape), tuple(shape))


def _wrap_edges(masks, open_labels, shape):
    """The wrap bonds as edges of the contracted graph: the nodes ``a -> c``
    (open labels) int64 ``[B, E]``, their shifts ``[E, 2]`` and whether each
    is active ``[B, E]`` (``E = L1 + L0``: the last row's bonds, then the
    last column's)."""
    l0, l1 = shape
    dev = masks.device
    cols, rows = torch.arange(l1, device=dev), torch.arange(l0, device=dev)
    u = torch.cat([(l0 - 1) * l1 + cols, rows * l1 + l1 - 1])
    v = torch.cat([cols, rows * l1])
    shift = torch.tensor([[1, 0]] * l1 + [[0, 1]] * l0, dtype=torch.int64, device=dev)
    on = torch.cat([masks[:, u[:l1], 0], masks[:, u[l1:], 1]], 1)
    lab = open_labels.long()
    return lab[:, u], lab[:, v], shift, on


def _contract(masks, open_labels, shape):
    """The contracted graph settled: each node's root (the smallest node of
    its component) and sheet int64 ``[B, n]`` / ``[B, n, 2]``, a spanning
    forest's potential: one round at a time, a node takes the root and the
    shifted sheet of an edge's other end whose root is smaller than its own
    (the smallest root, then the smallest sheet key, where several offer
    it), as the plain version's settle loop takes a settled neighbour's;
    then the edges.  Nodes are indexed by open label; the others stay
    their own roots."""
    a, c, shift, on = _wrap_edges(masks, open_labels, shape)
    b, n = open_labels.shape
    span = 2 * (sum(shape) + 1)  # |sheet| <= nodes <= 2 (L0 + L1)
    base = 2 * span + 1
    key_of = lambda r, sh: (r * base + (sh[..., 0] + span)) * base + (sh[..., 1] + span)  # noqa: E731
    root = torch.arange(n, device=masks.device).expand(b, n).clone()
    sheet = torch.zeros((b, n, 2), dtype=torch.int64, device=masks.device)
    big = torch.iinfo(torch.int64).max
    while True:
        ra, rc = root.gather(1, a), root.gather(1, c)
        sa = sheet.gather(1, a[..., None].expand(-1, -1, 2))
        sc = sheet.gather(1, c[..., None].expand(-1, -1, 2))
        offers = torch.cat([key_of(ra, sa + shift), key_of(rc, sc - shift)], 1)
        offers = torch.where(torch.cat([on, on], 1), offers, big)
        best = torch.full((b, n), big, dtype=torch.int64, device=masks.device)
        best.scatter_reduce_(1, torch.cat([c, a], 1), offers, "amin")
        take = best // (base * base) < root
        if not bool(take.any()):
            return root, sheet, (a, c, shift, on)
        root = torch.where(take, best // (base * base), root)
        sheet = torch.where(take[..., None], torch.stack(
            [best // base % base - span, best % base - span], -1), sheet)


def winding_wrap_plain(masks, open_labels, shape):
    """The flags ``winding_wrap`` computes from the open labels: bool ``(wx,
    wy) [B]``, an active wrap bond whose ends' sheets differ by other than
    its shift along that axis."""
    _, sheet, (a, c, shift, on) = _contract(masks, open_labels, shape)
    sa = sheet.gather(1, a[..., None].expand(-1, -1, 2))
    sc = sheet.gather(1, c[..., None].expand(-1, -1, 2))
    bad = on[..., None] & (sc - sa != shift)
    return bad[..., 0].any(-1), bad[..., 1].any(-1)


def winding_check_plain(masks, labels, shape):
    """The error mark of ``winding_check`` (and the whole form): bool
    ``[B]``, a component of the bond graph holds no site whose label is
    itself (where the plain version raises)."""
    b, n = labels.shape
    sites = torch.arange(n, device=labels.device)
    comp = connected_components(masks, tuple(shape)).long()
    held = torch.zeros((b, n), dtype=torch.int32, device=labels.device)
    held.scatter_add_(1, comp, (labels == sites).to(torch.int32))
    return ((comp == sites) & (held == 0)).any(-1)


def winding_border_unions(boxes, masks, shape, tile):
    """``winding_border`` in plain torch: the open bonds that leave a box
    (not the wrap bonds) united over the boxes' parents ``boxes`` (each
    site's box root), a round at a time: every parent pointed at its root,
    then each bond's two roots hung under the smaller of them.  Returns
    int32 ``[B, n]``, every parent its root: the open labels."""
    shape = tuple(shape)
    leave = open_masks(masks, shape) & ~tile_bonds(shape, 2, tile, masks.device)
    g, i, d = torch.nonzero(leave, as_tuple=True)
    j = torch.where(d == 0, i + shape[1], i + 1)
    n = boxes.shape[1]
    p = boxes.long()
    while True:
        p = fk_link_flatten_plain(p).long()
        ra, rb = p[g, i], p[g, j]
        lo = torch.minimum(ra, rb)
        q = p.view(-1).clone()
        q.scatter_reduce_(0, torch.cat([g * n + ra, g * n + rb]), torch.cat([lo, lo]), "amin")
        q = q.view_as(p)
        if torch.equal(q, p):
            return p.to(torch.int32)
        p = q


def winding_flags_open(masks, labels, shape, tile=None):
    """The kernels' decomposition in plain torch: the open graph in boxes of
    ``tile`` (default: the kernels' plan), the open bonds that leave them,
    the wrap edges of the open components, the error check.  Raises
    ``ValueError`` where the plain version does."""
    shape = tuple(int(s) for s in shape)
    tile = tuple(tile or winding_plan(shape, masks.shape[0]).tile)
    boxes = winding_link_plain(masks, shape, tile)
    open_labels = winding_border_unions(boxes, masks, shape, tile)
    if bool(winding_check_plain(masks, labels, shape).any()):
        raise ValueError("winding: sites left unsettled, the labels do not belong "
                         "to the bond masks")
    return winding_wrap_plain(masks, open_labels, shape)
