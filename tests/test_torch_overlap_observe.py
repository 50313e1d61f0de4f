"""Overlap observe (``overlap_cluster_action="observe"``) in the port,
against the JAX package, and the sample() checks that come with it.

* The engine with ``houdayer+jorg+cmr`` SW observe at 8x64 (R = 2, the
  canonical 2D square: winding flags) and at 8^3 (R = 4) against the
  reference's engine in interpret mode, the port's uniform sources patched
  to zeros: states bitwise; ``cluster_observations`` (``houdayer``,
  ``jorg``, ``cmr_blue``) with the reference's keys, dtypes and shapes,
  integers bitwise and fractions to rtol 1e-6 (the reference sums them in
  f32); ``overlap_csd`` and ``top_cluster_sizes`` bitwise.
* Observe mutates nothing: spins, sid and records bitwise those of the run
  without overlap moves; on the plain path, the move's observe form writes
  no spin and labels CMR's blue graph.
* The schema of the new result keys, the houdN-observe ``ValueError`` and
  the ``autocorrelation_backend`` check, whose messages are the
  reference's.
"""

import numpy as np
import pytest
import torch

from peapods_tpu.engine.simulation import IsingSimulation as RefSimulation
from peapods_tpu_torch import Ising
from peapods_tpu_torch.engine import seeds
from peapods_tpu_torch.engine.simulation import IsingSimulation
from peapods_tpu_torch.ops import overlap
from peapods_tpu_torch.ops import rng as trng

torch.set_num_threads(1)

OBS_KEYS = ("observation_count", "cluster_size_counts", "top_four_component_fractions",
            "active_bond_density", "large_component_count")
WINDING_KEYS = ("winding_x", "winding_y", "winding_either", "winding_both")
OBSERVE = dict(overlap_cluster_update_interval=1, overlap_cluster_mode="sw",
               overlap_cluster_action="observe",
               overlap_cluster_build_mode="houdayer+jorg+cmr")


@pytest.fixture
def zero_uniforms(monkeypatch):
    """The reference's interpret mode draws zero site and bond uniforms; the
    port's plain path gets zeros in their place."""
    monkeypatch.setenv("PEAPODS_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(
        trng, "colour_uniforms",
        lambda words, n, c, shape: torch.zeros(words.shape[:-1] + (n, *shape)))
    monkeypatch.setattr(
        trng, "bond_uniforms",
        lambda words, n, n_dirs=2, first=0: torch.zeros(words.shape[:-1] + (n, n_dirs)))


@pytest.mark.parametrize("shape,n_rep,winding", [((8, 64), 2, True), ((8, 8, 8), 4, False)],
                         ids=["8x64-winding", "8cube"])
def test_engine_observe_matches_reference_under_zero_uniforms(zero_uniforms, shape,
                                                              n_rep, winding):
    rng = np.random.default_rng(3)
    nd = len(shape)
    coup = rng.choice(np.float32([-1, 1]), size=(2,) + tuple(shape) + (nd,))
    temps = np.geomspace(0.9, 2.2, 3).astype(np.float32)
    kw = dict(OBSERVE, pt_interval=1, warmup_ratio=0.25)
    ref = RefSimulation(list(shape), coup, temps, n_rep, None, 5, mesh=None)
    r_ref = ref.sample(8, "metropolis", **kw)
    prog = next(iter(ref._programs.values()))
    assert prog.megapair and prog.event_kernel and prog.with_winding == winding
    port = IsingSimulation(list(shape), coup, temps, n_rep, None, 5, device="cpu")
    r_port = port.sample(8, "metropolis", **kw)
    for key in ("spins", "system_ids", "pt_edge_acceptances", "pt_round_trips"):
        np.testing.assert_array_equal(port.state[key].numpy(),
                                      np.asarray(ref.state[key]), err_msg=key)
    obs_p = r_port["per_disorder"]["cluster_observations"]
    obs_r = r_ref["per_disorder"]["cluster_observations"]
    assert list(obs_p) == list(obs_r) == ["houdayer", "jorg", "cmr_blue"]
    for name in obs_r:
        want = set(OBS_KEYS + (WINDING_KEYS if winding else ()))
        assert set(obs_p[name]) == set(obs_r[name]) == want, name
        for key, b in obs_r[name].items():
            a = obs_p[name][key]
            assert a.dtype == b.dtype and a.shape == b.shape, (name, key)
            if b.dtype == np.uint64:
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {key}")
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f"{name} {key}")
        # 6 recorded sweeps, one kind each in turn, n_rep // 2 groups a move
        assert obs_p[name]["observation_count"].tolist() == [[2 * (n_rep // 2)] * 3] * 2
    for m in range(3):
        for a, b in zip(r_port["overlap_csd"][m], r_ref["overlap_csd"][m]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(r_port["top_cluster_sizes"][m],
                                      r_ref["top_cluster_sizes"][m])


@pytest.mark.parametrize("shape,n_rep", [((8, 64), 2), ((8, 8, 8), 4)],
                         ids=["8x64", "8cube"])
def test_observe_leaves_the_trajectory_alone(shape, n_rep):
    def run(**kw):
        m = Ising(shape, couplings="bimodal", temperatures=[0.9, 1.4, 2.2],
                  n_replicas=n_rep, n_disorder=2, seed=13, device="cpu")
        r = m.sample(6, pt_interval=1, warmup_ratio=0, **kw)
        return m, r

    plain, r_plain = run()
    obs, r_obs = run(**OBSERVE)
    for key in ("spins", "system_ids", "pt_edge_acceptances", "pt_round_trips"):
        assert torch.equal(obs._sim.state[key], plain._sim.state[key]), key
    for key in ("energies", "energies2", "mags2", "overlap", "overlap2",
                "link_overlap2"):
        np.testing.assert_array_equal(r_obs[key], r_plain[key], err_msg=key)
    counts = r_obs["per_disorder"]["cluster_observations"]["jorg"]["observation_count"]
    assert counts.tolist() == [[2 * (n_rep // 2)] * 3] * 2


@pytest.mark.parametrize("kind", ["houdayer", "jorg", "cmr"])
def test_observe_form_writes_no_spin(kind):
    shape, d, n_rep, n_temps = (4, 4, 6), 2, 4, 3
    n = 96
    rng = np.random.default_rng(5)
    spins = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8),
                                        size=(d, n_rep * n_temps, n)))
    sid = torch.from_numpy(np.stack([rng.permutation(n_rep * n_temps)
                                     for _ in range(d)]).astype(np.int32))
    coup = torch.from_numpy(rng.choice([-1.0, 1.0], size=(d, n, 3)).astype(np.float32))
    temps = torch.tensor([0.9, 1.4, 2.0])
    tasks, tkeys = seeds.overlap_tasks(np.array([[1, 2], [3, 4]], np.uint32), [7],
                                       n_rep, n_temps)
    scal, probes = seeds.event_scalars(kind, False, tkeys[0], n)
    tab = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        tasks[0], scal.reshape(-1, 6), probes.reshape(-1, 64),
        tkeys[0].view(np.int32).reshape(-1, 2))]
    args = (sid, tab[0], coup, temps, *tab[1:])
    kw = dict(kind=kind, wolff=False, shape=shape, with_labels=True, with_masks=True)
    moved = spins.clone()
    upd = overlap.overlap_event_plain(moved, *args, **kw)
    seen = spins.clone()
    obs = overlap.overlap_event_plain(seen, *args, observe=True, **kw)
    assert torch.equal(seen, spins) and not torch.equal(moved, spins)
    # the same stats graph: the move's, CMR's blue one
    assert torch.equal(obs.stats, upd.stats)
    assert torch.equal(obs.masks, upd.masks)
    assert (obs.labels is None) == (kind == "cmr")
    assert obs.masks.shape == (d * n_temps * (n_rep // 2), n, 3)


def test_result_schema():
    m = Ising((4, 4), couplings="bimodal", temperatures=[1.0, 2.0], n_replicas=4,
              n_disorder=2, seed=3, device="cpu")
    r = m.sample(8, pt_interval=1, overlap_cluster_update_interval=2,
                 overlap_cluster_build_mode="jorg+houd4", overlap_cluster_mode="sw",
                 collect_cluster_stats=True, warmup_ratio=0)
    assert len(r["overlap_csd"]) == 2 and len(r["overlap_csd"][0]) == 2
    assert all(h.dtype == np.uint64 and h.shape == (17,) for per in r["overlap_csd"]
               for h in per)
    # 2 moves of each mode, 2 realizations, groups of 2 (jorg) or 4 (houd4)
    for mode, groups in ((0, 2), (1, 1)):
        total = sum(int((np.arange(17) * h.astype(np.int64)).sum())
                    for h in r["overlap_csd"][mode])
        assert total == 2 * 2 * 2 * groups * 16
    assert [t.shape for t in r["top_cluster_sizes"]] == [(2, 4), (2, 4)]
    assert all(t.dtype == np.float64 for t in r["top_cluster_sizes"])
    assert "cluster_observations" not in r.get("per_disorder", {})
    assert m.top_cluster_sizes is r["top_cluster_sizes"]
    # the top-4 sizes over n_pairs moves: a houd4 group fills at most half
    assert float(r["top_cluster_sizes"][1].sum(1).max()) <= 0.5


def test_observe_kind_skipped_unless_every_realization_observed():
    m = Ising((4, 4), couplings="bimodal", temperatures=[2.0], n_replicas=2,
              n_disorder=2, seed=3, device="cpu")
    r = m.sample(3, **dict(OBSERVE, overlap_cluster_update_interval=4),
                 warmup_ratio=0.5)
    assert "cluster_observations" not in r.get("per_disorder", {})
    assert "overlap_csd" not in r


def test_houdn_observe_and_ac_backend_raise_as_the_reference():
    coup = np.ones((4, 4, 2), np.float32)
    for engine in (IsingSimulation([4, 4], coup, [2.0], 4, None, 1, device="cpu"),
                   RefSimulation([4, 4], coup, [2.0], 4, None, 1, mesh=None)):
        with pytest.raises(ValueError, match="does not support experimental houdN"):
            engine.sample(2, "metropolis", overlap_cluster_update_interval=1,
                          overlap_cluster_build_mode="houd4", overlap_cluster_mode="sw",
                          overlap_cluster_action="observe")
    msgs = []
    for engine in (IsingSimulation([4, 4], coup, [2.0], 2, None, 1, device="cpu"),
                   RefSimulation([4, 4], coup, [2.0], 2, None, 1, mesh=None)):
        with pytest.raises(ValueError) as bad:
            engine.sample(2, "metropolis", autocorrelation_backend="welch")
        with pytest.raises(ValueError) as fft:
            engine.sample(2, "metropolis", autocorrelation_backend="fft")
        msgs.append((str(bad.value), str(fft.value)))
        assert int(engine.state["counter"]) == 0  # raised before anything ran
    assert msgs[0] == msgs[1]
    assert "unknown autocorrelation_backend 'welch'" in msgs[0][0]
