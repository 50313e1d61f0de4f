"""The port's band forms of the sweep, the measurement, the connected
components and the FK update (a lattice split into row bands over a
``space`` mesh), against the unsharded port and the JAX package.

* Each band's colour passes (``sweep_halo_plain``), run band by band with
  the halos copied between passes and the sweep's Philox words, are
  bitwise the unsharded pass (``sweep_2d_plain`` on the square lattice,
  ``sweep_nb_plain`` on the others): spins and m bitwise; e bitwise with
  +-1 couplings, whose sums are integers, and within 1e-6 sum |J| with
  gaussian ones, whose band sums are added in another order.
* With injected uniforms, each band is bitwise the reference's halo twin in
  interpret mode, band by band with hand-carried halos: row 5
  (``sweep_2d_halo_color_injected``), row 6 (its lane-packed twin, k = 2),
  row 9 (``sweep_3d_halo_color_injected``), row 13
  (``sweep_gen_halo_color_injected`` on the triangular, FCC and NNN
  lattices), Metropolis and Gibbs, both colours (+-1 couplings: the
  reference adds the field in another order).  A flip decision whose
  uniform lies within 4 ulp of its probability is an ``exp`` rounding tie
  between XLA and torch and is counted apart; none is expected here.
* The fused measure (rows 5 and 9, ``with_measure=True``) against the
  reference's kernels in interpret mode, which draw zero uniforms.
* The banded CC over 1, 2 and 4 bands, bitwise the unsharded labels and
  the reference's ``connected_components_banded`` under ``jax.shard_map``
  on a 4-device CPU mesh with its Pallas band kernel (row 17) in interpret
  mode (``tests/test_torch_cc_band.py`` holds its steps).
* The FK band forms, bitwise the unsharded FK update and staged path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from peapods_tpu.ops import cluster as ref_cluster
from peapods_tpu.ops import pallas_sweep as ps
from peapods_tpu.ops import pallas_sweep3d as ps3
from peapods_tpu.ops import pallas_sweep_diag as psd
from peapods_tpu.ops.geometry import GridOps
from peapods_tpu.ops.lattice import Lattice as RefLattice
from peapods_tpu_torch.ops import cc_band, fk, halo
from peapods_tpu_torch.ops import rng as trng
from peapods_tpu_torch.ops import sweep as tsweep
from peapods_tpu_torch.ops.cluster import connected_components
from peapods_tpu_torch.ops.energy import measure_nb_plain
from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, BandGeometry, Lattice

torch.set_num_threads(1)

TRI = GEOMETRY_OFFSETS["triangular"]
FCC = GEOMETRY_OFFSETS["fcc"]
BCC = GEOMETRY_OFFSETS["bcc"]
NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]


def _couplings(rng, n, nb, kind):
    if kind == "pm":
        return rng.choice([-1.0, 1.0], size=(n, nb)).astype(np.float32)
    return rng.standard_normal((n, nb)).astype(np.float32)


def _windows(spins, geom):
    """The bands' windows ``[d, S, n_window]`` of spins ``[d, S, n]``."""
    return [spins[..., torch.from_numpy(b.window_sites())].clone() for b in geom.bands]


# ------------------------------------------------- bands against the unsharded pass


BANDED = [
    ("square", (16, 16), None, 4),
    ("square-split", (6, 6), None, 3),  # band starts split Philox groups
    ("cubic", (8, 4, 6), None, 4),
    ("tri", (16, 16), TRI, 4),
    ("bcc", (8, 4, 8), BCC, 2),
    ("fcc", (8, 8, 4), FCC, 4),
    ("nnn", (16, 16), NNN, 4),
]


@pytest.mark.parametrize("couplings", ["pm", "gauss"])
@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
@pytest.mark.parametrize("name,shape,offsets,ns", BANDED, ids=[b[0] for b in BANDED])
def test_band_passes_match_the_unsharded_sweep(name, shape, offsets, ns, gibbs,
                                               couplings):
    lat = Lattice(shape, offsets)
    geom = BandGeometry(lat, ns)
    rng = np.random.default_rng(7 + ns)
    d, n_sys = 2, 3
    coup = np.stack([_couplings(rng, lat.n_spins, lat.n_neighbors, couplings)
                     for _ in range(d)])
    spins = torch.from_numpy(rng.choice([-1, 1], size=(d, n_sys, lat.n_spins))
                             .astype(np.int8))
    temps = torch.from_numpy(rng.uniform(1.5, 4.0, (d, n_sys)).astype(np.float32))
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (d, 2)).astype(np.int32))
    cf = torch.from_numpy(coup)
    cb = torch.stack([torch.from_numpy(coup[:, lat.bwd[:, k], k])
                      for k in range(lat.n_neighbors)], -1)
    want = spins.clone()
    if lat.square:
        tsweep.sweep_2d_plain(want.view(d, n_sys, *shape),
                              tsweep.pack_coupling_grids(cf, shape), temps, words,
                              gibbs=gibbs)
    else:
        tsweep.sweep_nb_plain(want, cf, cb, torch.from_numpy(lat.colors.astype(np.uint8)),
                              temps, words, lat, gibbs=gibbs)
    e_want, m_want = measure_nb_plain(want, cf, lat)

    wins = _windows(spins, geom)
    ins = [halo.band_couplings(coup, b, "cpu") for b in geom.bands]
    cols = [torch.from_numpy(lat.colors[b.window_sites()].astype(np.uint8))
            for b in geom.bands]
    parts = None
    for colour in range(lat.n_colors):
        halo.exchange(wins, geom.bands)
        last = colour == lat.n_colors - 1 and lat.hypercubic
        parts = [halo.sweep_halo(w, f, bw, col, temps, words, b, colour, gibbs=gibbs,
                                 measure=last)
                 for w, (f, bw), col, b in zip(wins, ins, cols, geom.bands)]
    got = halo.gather_band_spins(wins, geom.bands)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    halo.exchange(wins, geom.bands)
    meas = [halo.measure_halo(w, f, b) for w, (f, _), b in zip(wins, ins, geom.bands)]
    for p in ([parts] if lat.hypercubic else []) + [meas]:
        e = torch.cat([x[0] for x in p], -1).sum(-1)
        m = torch.cat([x[1] for x in p], -1).sum(-1)
        np.testing.assert_array_equal(m.numpy(), m_want[..., 0].numpy())
        if couplings == "pm":
            np.testing.assert_array_equal(e.numpy(), e_want[..., 0].numpy())
        else:
            tol = 1e-6 * np.abs(coup).sum(axis=(1, 2))[:, None]
            assert (np.abs(e.numpy() - e_want[..., 0].numpy()) <= tol).all()


def test_band_geometry_refuses_what_it_cannot_split():
    with pytest.raises(ValueError, match="space"):
        BandGeometry(Lattice((6, 8)), 4)
    with pytest.raises(ValueError, match="halo"):
        BandGeometry(Lattice((8, 8), [[2, 1], [0, 1]]), 8)
    assert BandGeometry(Lattice((8, 8), [[2, 1], [0, 1]]), 4).halo == 2


# ------------------------------------------------- bands against the Pallas twins


def _ties(c, field, temps, u, active, gibbs):
    """bool: active sites whose uniform lies within 4 ulp of its flip
    probability (the port's arithmetic)."""
    x = (-c * field) * (1.0 / (0.5 * temps))[..., None]
    p = tsweep.acceptance(x, gibbs=gibbs)
    ulp = (torch.nextafter(p, torch.tensor(np.inf)) - p).abs()
    return ((u - p).abs() <= 4 * ulp) & active


def _band_pass(lat, geom, k, s_glob, coup, temps, u_glob, colour, gibbs):
    """One band's pass with the port's plain version on the global state
    ``[S, n]`` and uniforms ``[S, n]``: the band's new spins ``[S,
    n_band]`` and its tie mask."""
    b = geom.bands[k]
    win = torch.from_numpy(s_glob[:, b.window_sites()])[None].clone()
    f, bw = halo.band_couplings(coup[None], b, "cpu")
    col = torch.from_numpy(lat.colors[b.window_sites()].astype(np.uint8))
    t = torch.from_numpy(temps)[None]
    u = torch.from_numpy(u_glob[:, b.band_sites()])[None]
    # the field the pass sees, for the tie count
    c = win[..., b.interior].to(torch.float32)
    g = win.to(torch.float32).reshape(1, -1, *b.window_shape)
    field = torch.zeros_like(c)
    jf, jb = f[:, None, b.interior], bw[:, None, b.interior]
    for kk, off in enumerate(lat.offsets):
        field = field + halo._shift(g, off, b) * jf[..., kk]
        field = field + halo._shift(g, -off, b) * jb[..., kk]
    if lat.square:
        r = np.arange(b.hl)[:, None] + b.row0
        active = torch.from_numpy((((r + np.arange(lat.shape[1])) & 1) == colour)
                                  .reshape(-1))
    else:
        active = col[b.interior] == colour
    ties = _ties(c, field, t, u, active, gibbs)
    halo.sweep_halo_plain(win, f, bw, col, t, None, b, colour, gibbs=gibbs, uniforms=u)
    return win[0][:, b.interior].numpy(), ties[0].numpy()


def _assert_twin(got, want, ties, what):
    mism = got != want
    assert not (mism & ~ties).any(), f"{what}: {int((mism & ~ties).sum())} mismatches"
    assert ties.sum() == 0, f"{what}: {int(ties.sum())} exp ties"


@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
@pytest.mark.parametrize("colour", [0, 1])
def test_square_bands_match_halo_twin_row5(colour, gibbs):
    h, w, ns, n_sys = 16, 128, 4, 2
    lat = Lattice((h, w))
    geom = BandGeometry(lat, ns)
    hl = h // ns
    rng = np.random.default_rng(3 + colour)
    s = rng.choice([-1, 1], size=(n_sys, h * w)).astype(np.int8)
    coup = _couplings(rng, h * w, 2, "pm")
    u = rng.random((n_sys, h * w), dtype=np.float32)
    temps = np.array([1.7, 2.6], np.float32)
    jg = np.asarray(ps.pack_coupling_grids(jnp.asarray(coup), (h, w)))
    sg = s.reshape(n_sys, h, w)
    for k in range(ns):
        band = slice(k * hl, (k + 1) * hl)
        want = ps.sweep_2d_halo_color_injected(
            jnp.asarray(sg[:, band]), jnp.asarray(jg[:, band]), jnp.asarray(temps),
            jnp.asarray(u.reshape(n_sys, h, w)[:, band]),
            jnp.asarray(sg[:, (k * hl - 1) % h][:, None]),
            jnp.asarray(sg[:, ((k + 1) * hl) % h][:, None]),
            jnp.full((1, 1), k * hl, jnp.int32), shape_local=(hl, w), color=colour,
            gibbs=gibbs, interpret=True)
        got, ties = _band_pass(lat, geom, k, s, coup, temps, u, colour, gibbs)
        _assert_twin(got, np.asarray(want).reshape(n_sys, -1), ties, f"band {k}")


@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
@pytest.mark.parametrize("colour", [0, 1])
def test_narrow_square_bands_match_packed_halo_twin_row6(colour, gibbs):
    h, w, k_pack, ns = 32, 64, 2, 2
    lat = Lattice((h, w))
    geom = BandGeometry(lat, ns)
    hl = h // ns
    rng = np.random.default_rng(9 + colour)
    s = rng.choice([-1, 1], size=(k_pack, h * w)).astype(np.int8)
    coup = _couplings(rng, h * w, 2, "pm")
    u = rng.random((k_pack, h * w), dtype=np.float32)
    temps = np.array([1.3, 2.1], np.float32)
    jgp = np.asarray(ps.pack_coupling_grids_packed(jnp.asarray(coup), (h, w), k_pack))
    sg = s.reshape(k_pack, h, w)
    for k in range(ns):
        band = slice(k * hl, (k + 1) * hl)
        pack = lambda x: ps.pack_spins(jnp.asarray(x.reshape(k_pack, -1)), (hl, w),  # noqa: E731
                                       k_pack)
        halo_row = lambda r: jnp.asarray(np.concatenate(  # noqa: E731
            [sg[j, r % h] for j in range(k_pack)])[None, None])
        res = ps.sweep_2d_halo_color_packed_injected(
            pack(sg[:, band]), jnp.asarray(jgp[:, band]), jnp.asarray(temps),
            pack(u.reshape(k_pack, h, w)[:, band]), halo_row(k * hl - 1),
            halo_row((k + 1) * hl), jnp.full((1, 1), k * hl, jnp.int32),
            shape_local=(hl, w), k=k_pack, color=colour, gibbs=gibbs, interpret=True)
        want = np.asarray(ps.unpack_spins(res, (hl, w), k_pack)).reshape(k_pack, -1)
        got, ties = _band_pass(lat, geom, k, s, coup, temps, u, colour, gibbs)
        _assert_twin(got, want, ties, f"band {k}")


@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
@pytest.mark.parametrize("colour", [0, 1])
def test_cubic_bands_match_halo3d_twin_row9(colour, gibbs):
    shape, kp, n_sys, ns = (16, 8, 8), 2, 2, 2
    l0, l1, l2 = shape
    block = l1 * l2
    l0l = l0 // ns
    lat = Lattice(shape)
    geom = BandGeometry(lat, ns)
    rng = np.random.default_rng(11 + colour)
    s = rng.choice([-1, 1], size=(n_sys, lat.n_spins)).astype(np.int8)
    coup = _couplings(rng, lat.n_spins, 3, "pm")
    u = rng.random((n_sys, lat.n_spins), dtype=np.float32)
    temps = np.array([3.5, 5.0], np.float32)
    jg = np.asarray(ps3.pack_coupling_grids_3d(jnp.asarray(coup), shape, kp, 1))
    sg = s.reshape(n_sys, l0, block)
    pack = lambda x, rows: ps3.pack_rows_3d(  # noqa: E731
        jnp.asarray(x.reshape(n_sys, rows * block)), rows, block, kp, 1)
    for k in range(ns):
        band = slice(k * l0l, (k + 1) * l0l)
        res = ps3.sweep_3d_halo_color_injected(
            pack(sg[:, band], l0l), jnp.asarray(jg[:, band]), jnp.asarray(temps),
            pack(u.reshape(n_sys, l0, block)[:, band], l0l).astype(jnp.float32),
            pack(sg[:, (k * l0l - 1) % l0], 1), pack(sg[:, ((k + 1) * l0l) % l0], 1),
            jnp.full((1, 1), k * l0l, jnp.int32), shape_local=(l0l, l1, l2), kp=kp,
            color=colour, gibbs=gibbs, interpret=True)
        want = np.asarray(ps3.unpack_rows_3d(res, l0l, block, kp, 1)).reshape(n_sys, -1)
        got, ties = _band_pass(lat, geom, k, s, coup, temps, u, colour, gibbs)
        _assert_twin(got, want, ties, f"band {k}")


GEN = [("tri", (16, 128), TRI), ("fcc", (16, 16, 8), FCC), ("nnn", (16, 128), NNN)]


@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
@pytest.mark.parametrize("name,shape,offsets", GEN, ids=[g[0] for g in GEN])
def test_coloured_bands_match_gen_halo_twin_row13(name, shape, offsets, gibbs):
    ns, n_sys = 2, 2
    ref = RefLattice(list(shape), offsets)
    lat = Lattice(shape, offsets)
    geom = BandGeometry(lat, ns)
    np.testing.assert_array_equal(lat.colors, np.asarray(ref.colors))
    meta, m = psd.halo_gen_meta(ref, n_sys, ns)
    shape3, offs3, periods, table, n_colors = meta
    gen = (offs3, periods, table, n_colors)
    l0, l1, l2 = shape3
    block = l1 * l2
    hl = l0 // ns
    rng = np.random.default_rng(17)
    s = rng.choice([-1, 1], size=(n_sys, lat.n_spins)).astype(np.int8)
    coup = _couplings(rng, lat.n_spins, lat.n_neighbors, "pm")
    temps = np.array([1.5, 6.0], np.float32)
    jg = psd.pack_coupling_grids_gen(jnp.asarray(coup), ref, 1)
    for colour in range(lat.n_colors):
        u = rng.random((n_sys, lat.n_spins), dtype=np.float32)
        sg = s.reshape(n_sys, l0, block)
        new = s.copy()
        for k in range(ns):
            r0 = k * hl
            rows = np.arange(r0 - m, r0 + hl + m) % l0
            out = psd.sweep_gen_halo_color_injected(
                jnp.asarray(sg[:, rows]), jnp.pad(jg[:, r0:r0 + hl], ((0, 0), (m, m), (0, 0))),
                jnp.asarray(temps), jnp.asarray(u.reshape(n_sys, l0, block)[:, rows]),
                jnp.full((1, 1), r0, jnp.int32), shape_local=(hl, l0, l1, l2), gen=gen,
                color=colour, m=m, gibbs=gibbs, interpret=True)
            want = np.asarray(out)[:, m:m + hl].reshape(n_sys, -1)
            got, ties = _band_pass(lat, geom, k, s, coup, temps, u, colour, gibbs)
            _assert_twin(got, want, ties, f"colour {colour} band {k}")
            new[:, geom.bands[k].band_sites()] = got
        s = new


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_fused_measure_matches_the_reference_kernels(dim):
    """Rows 5 and 9 with ``with_measure=True``: the reference's kernels in
    interpret mode draw zero uniforms (every active site whose acceptance
    is positive flips); the port's pass is given zeros."""
    ns, n_sys = 2, 2
    shape = (16, 128) if dim == "2d" else (16, 8, 8)
    lat = Lattice(shape)
    geom = BandGeometry(lat, ns)
    block = lat.n_spins // shape[0]
    hl = shape[0] // ns
    rng = np.random.default_rng(23)
    s = rng.choice([-1, 1], size=(n_sys, lat.n_spins)).astype(np.int8)
    coup = _couplings(rng, lat.n_spins, lat.n_neighbors, "pm")
    temps = np.array([1.9, 4.4], np.float32)
    sg = s.reshape(n_sys, shape[0], block)
    seeds = jnp.zeros((1, 2 * n_sys), jnp.int32)
    for k in range(ns):
        band = slice(k * hl, (k + 1) * hl)
        up, dn = sg[:, (k * hl - 1) % shape[0]], sg[:, ((k + 1) * hl) % shape[0]]
        off = jnp.full((1, 1), k * hl, jnp.int32)
        if dim == "2d":
            jg = np.asarray(ps.pack_coupling_grids(jnp.asarray(coup), shape))
            _, e_ref, m_ref = ps.sweep_2d_halo_color(
                jnp.asarray(sg[None, :, band]), jnp.asarray(jg[None, :, band]),
                jnp.asarray(temps)[None], seeds, jnp.asarray(up[None, :, None]),
                jnp.asarray(dn[None, :, None]), off, shape_local=(hl, shape[1]),
                color=1, with_measure=True, interpret=True)
        else:
            kp = 2
            jg = np.asarray(ps3.pack_coupling_grids_3d(jnp.asarray(coup), shape, kp, 1))
            pack = lambda x, rows: ps3.pack_rows_3d(  # noqa: E731
                jnp.asarray(x.reshape(n_sys, rows * block)), rows, block, kp, 1)
            _, e_ref, m_ref = ps3.sweep_3d_halo_color(
                pack(sg[:, band], hl)[None], jnp.asarray(jg[None, :, band]),
                jnp.asarray(temps)[None], jnp.zeros((1, 2), jnp.int32),
                pack(up, 1)[None], pack(dn, 1)[None], off, shape_local=(hl,) + shape[1:],
                kp=kp, color=1, with_measure=True, interpret=True)
        b = geom.bands[k]
        win = torch.from_numpy(s[:, b.window_sites()])[None].clone()
        f, bw = halo.band_couplings(coup[None], b, "cpu")
        col = torch.from_numpy(lat.colors[b.window_sites()].astype(np.uint8))
        e, m = halo.sweep_halo_plain(
            win, f, bw, col, torch.from_numpy(temps)[None], None, b, 1, gibbs=False,
            measure=True, uniforms=torch.zeros((1, n_sys, b.n_band)))
        np.testing.assert_array_equal(e[0, :, 0].numpy(), np.asarray(e_ref)[0])
        np.testing.assert_array_equal(m[0, :, 0].numpy(), np.asarray(m_ref)[0])


# ------------------------------------------------- the banded CC (row 17)


CC_CASES = [("square", (16, 16), None), ("cubic", (8, 8, 8), None),
            ("tri", (16, 16), TRI), ("fcc", (8, 8, 8), FCC)]


def _reference_banded(masks, ref_lat):
    geom = GridOps.from_lattice(ref_lat)
    mesh = JaxMesh(np.array(jax.devices()[:4]), ("space",))
    call = jax.shard_map(
        lambda a: ref_cluster.connected_components_banded(
            a, geom, axis="space", pallas=True, interpret=True),
        mesh=mesh, in_specs=P(None, "space", None), out_specs=P(None, "space"),
        check_vma=False)
    return np.asarray(call(jnp.asarray(masks)))


@pytest.mark.parametrize("name,shape,offsets", CC_CASES, ids=[c[0] for c in CC_CASES])
def test_banded_cc_matches_unsharded_and_reference(name, shape, offsets):
    lat = Lattice(shape, offsets)
    rng = np.random.default_rng(31)
    masks = np.stack([rng.random((lat.n_spins, lat.n_neighbors)) < p
                      for p in (0.3, 0.6, 1.01)])
    mt = torch.from_numpy(masks)
    want = connected_components(mt, shape, lat.offsets).numpy()
    # all bonds on: spanning clusters (FCC's two parity sublattices)
    assert len(np.unique(want[-1])) <= 2
    for ns in (1, 2, 4):
        got = cc_band.band_cc_labels(mt, BandGeometry(lat, ns)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{ns} bands")
    np.testing.assert_array_equal(
        _reference_banded(masks, RefLattice(list(shape), offsets)), want)


def test_banded_cc_rounds_stop_when_nothing_falls():
    """A snake that crosses the band edges many times: the one fixed
    sequence (link, export, merge, write) gives every site its label 0."""
    lat = Lattice((8, 8))
    masks = np.zeros((1, 64, 2), bool)
    for r in range(8):  # a serpentine path through every site
        for c in range(7):
            masks[0, r * 8 + (c if r % 2 == 0 else c + 1), 1] = True
        masks[0, r * 8 + (7 if r % 2 == 0 else 0), 0] = r < 7
    geom = BandGeometry(lat, 4)
    mt = torch.from_numpy(masks)
    got = cc_band.band_cc_labels(mt, geom)
    assert (got == 0).all()


# ------------------------------------------------- the FK band forms


FK_CASES = [("square", (16, 16), None, 4), ("tri", (16, 16), TRI, 4),
            ("cubic", (8, 8, 8), None, 2), ("fcc", (8, 8, 8), FCC, 4)]


@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("name,shape,offsets,ns", FK_CASES, ids=[c[0] for c in FK_CASES])
def test_fk_band_forms_match_the_unsharded_update(name, shape, offsets, ns, wolff):
    lat = Lattice(shape, offsets)
    geom = BandGeometry(lat, ns)
    rng = np.random.default_rng(41)
    d, n_sys = 2, 2
    g = d * n_sys
    coup = np.stack([_couplings(rng, lat.n_spins, lat.n_neighbors, "pm")
                     for _ in range(d)])
    spins = torch.from_numpy(rng.choice([-1, 1], size=(g, lat.n_spins)).astype(np.int8))
    temps = torch.from_numpy(rng.uniform(1.0, 3.0, g).astype(np.float32))
    kb = torch.from_numpy(rng.integers(-2**31, 2**31, (g, 2)).astype(np.int32))
    scal = torch.from_numpy(np.stack([rng.integers(-2**31, 2**31, g),
                                      rng.integers(-2**31, 2**31, g),
                                      rng.integers(0, lat.n_spins, g)], -1)
                            .astype(np.int32))
    cf = torch.from_numpy(coup)
    want = spins.clone()
    staged = not fk.fused_lattice(lat)
    if staged:
        labels, _ = fk.fk_staged_plain(want.view(g, *shape), cf, temps, scal, kb, lat,
                                       wolff=wolff)
        e_want, m_want = measure_nb_plain(want.view(d, n_sys, -1), cf, lat)
        e_want, m_want = e_want.view(g), m_want.view(g)
    else:
        e_part, m_part, labels = fk.fk_update_plain(
            want.view(g, *shape), cf, temps, scal, kb, wolff=wolff, with_measure=True,
            with_labels=True)
        e_want, m_want = e_part[:, 0], m_part[:, 0]
    wins = [w.view(g, -1) for w in _windows(spins.view(d, n_sys, -1), geom)]
    jw = [halo.band_couplings(coup, b, "cpu")[0] for b in geom.bands]
    ccs = [cc_band.BandCC.empty(g, b, "cpu") for b in geom.bands]
    for w, j, cb, b in zip(wins, jw, ccs, geom.bands):
        fk.fk_bonds_band(w, j, temps, kb, cb, b)
    cc_band.banded_labels(ccs, geom.bands)
    got_labels = torch.cat([cb.labels[:, b.interior] for cb, b in zip(ccs, geom.bands)], -1)
    np.testing.assert_array_equal(got_labels.numpy(), labels.reshape(g, -1).numpy())
    seed_lab = fk.wolff_seed_labels(ccs, geom.bands, scal[:, 2]) if wolff else None
    if wolff:
        np.testing.assert_array_equal(
            seed_lab.numpy(), labels.reshape(g, -1).gather(1, scal[:, 2:].long())[:, 0])
    parts = [fk.fk_finish_band(w, cb, j, scal, seed_lab, b, wolff=wolff,
                               measure=not staged)
             for w, cb, j, b in zip(wins, ccs, jw, geom.bands)]
    got = torch.cat([w[:, b.interior] for w, b in zip(wins, geom.bands)], -1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if staged:
        halo.exchange(wins, geom.bands)
        parts = [halo.measure_halo(w.view(d, n_sys, -1), j, b)
                 for w, j, b in zip(wins, jw, geom.bands)]
        e = torch.cat([p[0] for p in parts], -1).sum(-1).view(g)
        m = torch.cat([p[1] for p in parts], -1).sum(-1).view(g)
    else:
        e = torch.cat([p[0] for p in parts], -1).sum(-1)
        m = torch.cat([p[1] for p in parts], -1).sum(-1)
    np.testing.assert_array_equal(e.numpy(), e_want.numpy())
    np.testing.assert_array_equal(m.numpy(), m_want.numpy())


def test_band_uniforms_are_the_lattice_uniforms():
    """``slot_uniforms_at`` / ``bond_uniforms_at`` at a band's sites are
    the band's slice of the whole lattice's draws."""
    words = torch.tensor([[123456789, -987654321], [5, -6]], dtype=torch.int32)
    whole = trng.colour_uniforms(words, 3, 1, (8, 12))
    idx = torch.arange(18, 42)  # colour sites of rows 3 .. 6
    band = trng.slot_uniforms_at(words, 3, 1, idx)
    np.testing.assert_array_equal(band.numpy(),
                                  whole[..., 3:7, 1::2].reshape(2, 3, -1).numpy())
    sites = trng.site_uniforms(words, 2, 0, 96)
    np.testing.assert_array_equal(trng.slot_uniforms_at(words, 2, 0, idx).numpy(),
                                  sites[..., 18:42].numpy())
    bonds = trng.bond_uniforms(words, 96, n_dirs=3)
    np.testing.assert_array_equal(trng.bond_uniforms_at(words, idx, 3).numpy(),
                                  bonds[:, 18:42].numpy())
