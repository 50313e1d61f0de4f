"""The device time of ``chip_smoke.py``'s profiled windows, on a synthetic
list of profiler events: ``device_time`` counts each kernel once by name,
and leaves out the CPU events (a torch op's record carries its kernels'
time) and the ``peapods/`` profiling scopes of ``utils/profiling.py``
(their device-side annotations span the kernels inside them); a window's
busy share (``busy_words``); and phase 38's bounds of the table forms
(``ea_bounds``, ``ea_pair_bound``), each counting what its form reads."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

import chip_smoke


def _ev(key, us, count=1, device=DeviceType.CUDA):
    return SimpleNamespace(key=key, self_device_time_total=us, count=count,
                           device_type=device)


EVENTS = [
    _ev("void (anonymous namespace)::sweep_nb_table_kernel(signed char*, ...)", 40.0, 4),
    _ev("void (anonymous namespace)::ov_bonds_table_kernel<1>(...)", 6.0, 2),
    _ev("void (anonymous namespace)::ov_bonds_table_kernel<2>(...)", 9.0, 3),
    _ev("void (anonymous namespace)::ov_bonds_kernel<2, 1, true>(...)", 1.0, 1),
    _ev("void (anonymous namespace)::pt_step_kernel(...)", 3.0, 2),
    _ev("Memcpy DtoD (Device -> Device)", 0.5, 2),
    # the scopes' device-side annotations: the kernels inside them again
    _ev("peapods/sweep", 47.0, 2),
    _ev("peapods/measure", 3.0, 2),
    # a torch op's CPU record and the launch API: not device work
    _ev("aten::copy_", 0.5, 2, DeviceType.CPU),
    _ev("cudaLaunchKernel", 0.0, 11, DeviceType.CPU),
    _ev("void at::native::elementwise_kernel<128, 2>(...)", 2.0, 4),
]


def test_device_time_counts_kernels_once_and_leaves_out_scopes_and_cpu_events():
    named, others = chip_smoke.device_time(
        EVENTS, ("sweep_nb_table", "ov_bonds_table", "ov_bonds", "pt_step"))
    assert named == {"sweep_nb_table": [40.0, 4], "ov_bonds_table": [15.0, 5],
                     "ov_bonds": [1.0, 1], "pt_step": [3.0, 2]}
    assert others == {"Memcpy DtoD (Device -> Device)": 0.5,
                      "void at::native::elementwise_kernel<128, 2>(...)": 2.0}
    assert not any(k.startswith(chip_smoke.SCOPE_PREFIX) for k in others)


def test_device_time_busy_share_of_a_window_is_at_most_one():
    """The window's sum without the scopes: 61.5 us of device work over a
    wall time of 64 us is a busy share below 1; counting the scopes made it
    above 1."""
    named, others = chip_smoke.device_time(EVENTS, ("sweep_nb_table", "pt_step"))
    busy = sum(t for t, _ in named.values()) + sum(others.values())
    assert busy == pytest.approx(61.5)
    assert busy / 64.0 < 1.0 < (busy + 47.0 + 3.0) / 64.0


def test_device_time_of_nothing_named():
    named, others = chip_smoke.device_time(EVENTS[:1])
    assert named == {} and list(others) == [EVENTS[0].key]


def test_busy_words_headline_is_the_unprofiled_share():
    """The busy share is the device time a sweep over the unprofiled wall
    time a sweep (the run's idle share is its complement); the window's own
    wall time gives ``busy_window`` beside it."""
    busy, words = chip_smoke.busy_words(30.0, 120.0, 1e6 / 40.0)
    assert busy == pytest.approx(0.75)
    assert "busy 0.750 of it" in words and "busy_window 0.250" in words


@pytest.mark.parametrize("nb", [4, 9, 32])
def test_ea_bounds_count_only_what_each_form_reads(nb):
    """Each table form's bound counts the bytes its form needs: a bond graph
    of ceil(nb / 8) bytes a site, the parents and the flipped spins in every
    finish, the graph only in SW's finishes (the non-singleton test), the
    seeds only in Wolff's, CMR's flip bytes only in CMR's."""
    n, d, t, flipped = 1000, 2, 3, 70
    lat = SimpleNamespace(n_spins=n, n_neighbors=nb)
    w = -(-nb // 8)
    b = d * t
    tab, cp = 4 * n * nb, 4 * d * n * nb
    ms = lambda x: x / chip_smoke.HBM_BYTES_S * 1e3  # noqa: E731
    jw = chip_smoke.ea_bounds(lat, d, t, 2, 1, flipped, "jorg", True)
    assert set(jw) == {"ov_bonds_table", "ov_finish_table"}
    assert jw["ov_finish_table"] == (pytest.approx(ms(4 * b * n + 2 * flipped + 4 * b)),
                                     "bytes")
    assert jw["ov_bonds_table"][0] == pytest.approx(
        max(ms(2 * b * n + cp + tab + w * b * n + 4 * b),
            3 * nb * b * n / chip_smoke.F32_FLOPS * 1e3))
    cs = chip_smoke.ea_bounds(lat, d, t, 2, 1, flipped, "cmr", False)
    assert cs["ov_finish_table"][0] == pytest.approx(
        ms(4 * b * n + 2 * flipped + w * b * n + b * n))
    assert cs["ov_mid_table"][0] == pytest.approx(max(
        ms(2 * b * n + cp + tab + (w + 4) * b * n + (w + 1) * b * n),
        3 * nb * b * n / chip_smoke.F32_FLOPS * 1e3))
    h4 = chip_smoke.ea_bounds(lat, d, t, 4, 1, flipped, "houdayer", True)
    assert set(h4) == {"houdn_bonds_table", "houdn_finish_table"}
    assert h4["houdn_finish_table"][0] == pytest.approx(ms(4 * b * n + 2 * flipped + 4 * b))
    assert h4["houdn_bonds_table"][0] == pytest.approx(max(
        ms(4 * b * n + tab + w * b * n + 4 * b), 4 * nb * b * n / chip_smoke.F32_FLOPS * 1e3))
    assert chip_smoke.ea_pair_bound(lat, d, 6)[0] == pytest.approx(max(
        ms(2 * 6 * d * n + tab + 8 * 6 * d), 2 * nb * 6 * d * n / chip_smoke.F32_FLOPS * 1e3))
