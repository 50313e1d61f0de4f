"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  On a machine
with a GPU (jax is not needed; ``--noconftest`` skips the JAX package's
test configuration):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

Kernel and plain version run on the same CUDA tensors, so both use the
card's ``expf``: flip decisions, PT decisions and the PT bookkeeping must
agree bit for bit.  With +-J couplings every energy sum is an exact integer
in f32, so e is bitwise too; with gaussian couplings the kernel adds its
per-block partials in another order than ``torch.sum``, and e agrees to
rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from peapods_tpu_torch import Ising
from peapods_tpu_torch.ops import mega
from peapods_tpu_torch.ops.sweep import pack_coupling_grids
from peapods_tpu_torch.ops.tempering import hot_cold_slots, init_trip_state

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _chunk_inputs(dev, seed, shape, d, n_temps, n, couplings):
    rng = np.random.default_rng(seed)
    h, w = shape
    if couplings == "pm":
        coup = rng.choice([-1.0, 1.0], size=(d, h * w, 2))
    else:
        coup = rng.standard_normal((d, h * w, 2))
    temps = np.geomspace(1.8, 3.2, n_temps).astype(np.float32)
    sid = np.stack([rng.permutation(n_temps) for _ in range(d)]).astype(np.int32)
    hot, _ = hot_cold_slots(temps)
    sid_t = torch.from_numpy(sid).to(dev)
    n_edges = n_temps - 1
    i32 = dict(dtype=torch.int32, device=dev)
    return dict(
        spins=torch.from_numpy(
            rng.choice([-1, 1], size=(d, n_temps, h, w)).astype(np.int8)).to(dev),
        jgrids=pack_coupling_grids(
            torch.from_numpy(coup.astype(np.float32)), shape).contiguous().to(dev),
        temps=torch.from_numpy(temps).to(dev),
        sid=sid_t,
        ea=torch.zeros((d, n_edges), **i32),
        ec=torch.zeros((d, n_edges), **i32),
        rtrips=torch.zeros((d, n_temps), **i32),
        tstate=init_trip_state(sid_t[:, None], hot),
        sweep_words=torch.from_numpy(
            rng.integers(-2**31, 2**31, (n, d, 2)).astype(np.int32)).to(dev),
        pt_words=torch.from_numpy(
            rng.integers(-2**31, 2**31, (n, d, 2)).astype(np.int32)).to(dev),
    )


@pytest.mark.parametrize(
    "shape,d,n_temps,gibbs,pt_full,pt_interval,sweep_base,couplings",
    [
        ((64, 64), 2, 5, False, False, 1, 0, "pm"),
        ((6, 10), 1, 3, True, True, 1, 0, "pm"),
        ((32, 128), 3, 6, False, True, 3, 5, "pm"),
        ((16, 48), 2, 4, True, False, 2, 1, "pm"),
        ((16, 16), 1, 4, False, False, None, 0, "gauss"),
    ],
    ids=["64-metropolis-single", "6x10-gibbs-full", "32x128-full-interval3",
         "16x48-gibbs-single-interval2", "16-gauss-no-pt"],
)
def test_mega_chunk_kernel_matches_plain(cuda, shape, d, n_temps, gibbs, pt_full,
                                         pt_interval, sweep_base, couplings):
    n = 24
    x = _chunk_inputs(cuda, 17 + d * n_temps, shape, d, n_temps, n, couplings)
    hot, cold = hot_cold_slots(x["temps"].cpu().numpy())
    kw = dict(sweep_base=sweep_base, parity=1, gibbs=gibbs,
              pt_interval=pt_interval, pt_full=pt_full, hot_slot=hot,
              cold_slot=cold)
    order = ("spins", "jgrids", "temps", "sid", "ea", "ec", "rtrips", "tstate",
             "sweep_words", "pt_words")
    k = {key: v.clone() for key, v in x.items()}
    p = {key: v.clone() for key, v in x.items()}
    mega.reset_launches()
    e_k, m_k, par_k = mega.mega_chunk(*(k[key] for key in order), **kw)
    torch.cuda.synchronize()
    assert mega.LAUNCHES == {"colour_pass": 2 * n, "pt_step": n}
    e_p, m_p, par_p = mega.mega_chunk_plain(*(p[key] for key in order), **kw)
    assert mega.LAUNCHES == {"colour_pass": 2 * n, "pt_step": n}

    for key in ("spins", "sid", "ea", "ec", "rtrips", "tstate"):
        assert torch.equal(k[key], p[key]), key
    assert par_k == par_p
    assert torch.equal(m_k, m_p)
    if couplings == "pm":
        assert torch.equal(e_k, e_p)
    else:
        torch.testing.assert_close(e_k, e_p, rtol=1e-5, atol=0)
    if pt_interval is not None:
        assert int(k["ea"].sum()) > 0


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = _chunk_inputs(cuda, 3, (8, 8), 1, 3, 2, "pm")
    args = [x[k] for k in ("spins", "jgrids", "sid", "temps")]
    words = x["sweep_words"][0]
    bad = [
        (0, x["spins"].to(torch.int32)),  # dtype
        (1, x["jgrids"].transpose(-1, -2)),  # not contiguous
        (2, x["sid"].to(torch.int64)),  # dtype
        (3, x["temps"].cpu()),  # device
    ]
    mega.reset_launches()
    for i, t in bad:
        a = list(args)
        a[i] = t
        with pytest.raises(ValueError):
            mega.colour_pass(*a, words, 0, gibbs=False)
    assert mega.LAUNCHES == {"colour_pass": 0, "pt_step": 0}


def test_sample_on_card_is_deterministic_with_the_cpu_schema(cuda):
    kw = dict(pt_interval=1, pt_schedule="full_ladder")
    temps = np.geomspace(1.8, 3.2, 4).astype(np.float32)
    a = Ising((8, 16), temperatures=temps, seed=4, device="cuda")
    b = Ising((8, 16), temperatures=temps, seed=4, device="cuda")
    ra, rb = a.sample(64, **kw), b.sample(64, **kw)
    for key in ("mags", "mags2", "mags4", "energies", "energies2"):
        np.testing.assert_array_equal(ra[key], rb[key], err_msg=key)
        assert np.isfinite(ra[key]).all()
    assert torch.equal(a._sim.state["spins"], b._sim.state["spins"])
    c = Ising((8, 16), temperatures=temps, seed=4, device="cpu")
    rc = c.sample(64, **kw)

    def schema(r):
        if isinstance(r, dict):
            return {k: schema(v) for k, v in r.items()}
        return np.shape(r), np.asarray(r).dtype

    assert schema(ra) == schema(rc)
    assert a._sim.state["spins"].device.type == "cuda"
