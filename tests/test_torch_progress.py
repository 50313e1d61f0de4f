"""Progress reporting, Ctrl-C and the profiling scopes of the port, on the
CPU.

* ``utils/progress.py`` ``ProgressPrinter`` writes the JAX package's text,
  byte for byte, under a patched clock, with the same rate limit and final
  newline.
* The engine calls ``progress`` after every chunk; left ``None``, it prints
  a progress line when stderr is a terminal and nothing otherwise (the
  JAX engine's rule, peapods_tpu/engine/simulation.py:353-359).
* The twins of tests/test_engine_edges.py's interrupt tests: a
  ``KeyboardInterrupt`` from ``progress`` leaves the simulation at the last
  whole chunk, usable, and its resumed run bitwise an uninterrupted one;
  SIGINT during a chunk is held until the chunk is done.
* ``utils/profiling.py``: ``phase_scope`` outside a profiler is the shared
  no-op context; a run inside ``trace(dir)`` writes a Chrome trace with the
  ``peapods/sweep`` and ``peapods/measure`` ranges.
"""

import io
import json
import signal
import time

import numpy as np
import pytest
import torch

from peapods_tpu.utils.progress import ProgressPrinter as RefPrinter
from peapods_tpu_torch import IsingSimulation
from peapods_tpu_torch.utils import profiling
from peapods_tpu_torch.utils.progress import ProgressPrinter

torch.set_num_threads(1)

COUP = np.ones((4, 4, 2), np.float32)
TEMPS = np.array([2.0, 3.0], np.float32)


def _sim(**kw):
    return IsingSimulation((4, 4), COUP, TEMPS, n_replicas=2, seed=9, default_chunk=4,
                           device="cpu", **kw)


def test_printer_text_matches_reference(monkeypatch):
    # calls 3 and 5 fall inside the rate limit and print nothing; the last
    # (done == total) always prints and ends the line once
    times = [10.0, 10.0, 10.5, 10.6, 11.2, 11.3, 12.0, 12.5]
    calls = [(4, 64), (8, 64), (12, 64), (40, 64), (44, 64), (64, 64), (64, 64)]
    out = {}
    for name, cls in (("ref", RefPrinter), ("port", ProgressPrinter)):
        ticks = iter(times)
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        buf = io.StringIO()
        printer = cls(stream=buf)
        for done, total in calls:
            printer(done, total)
        out[name] = buf.getvalue()
    assert out["port"] == out["ref"]
    lines = out["port"].split("\r")[1:]
    assert len(lines) == 5  # 7 calls, 2 inside the rate limit
    # the newline ends the first line at done == total, and only that one
    assert out["port"].count("\n") == 1 and lines[3].endswith("\n")
    assert lines[0].startswith("sweeps [==>")
    assert "64/64" in lines[-1]


def test_engine_reports_each_chunk():
    seen = []
    _sim().sample(16, "metropolis", pt_interval=1,
                  progress=lambda done, total: seen.append((done, total)))
    assert seen == [(4, 16), (8, 16), (12, 16), (16, 16)]


class _Stream(io.StringIO):
    def __init__(self, tty):
        super().__init__()
        self.tty = tty

    def isatty(self):
        return self.tty


@pytest.mark.parametrize("tty", [True, False])
def test_progress_line_only_on_a_terminal(monkeypatch, tty):
    err = _Stream(tty)
    monkeypatch.setattr("sys.stderr", err)
    _sim().sample(16, "metropolis", pt_interval=1)
    text = err.getvalue()
    if tty:
        assert text.startswith("\rsweeps [") and "16/16" in text and text.endswith("\n")
    else:
        assert text == ""


def test_interrupt_between_chunks_leaves_object_usable():
    sim = _sim()
    calls = []

    def boom(done, total):
        calls.append(done)
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        sim.sample(16, "metropolis", pt_interval=1, progress=boom)
    assert calls == [4]  # one chunk ran before the interrupt
    assert int(sim.state["counter"]) == 4

    spins = sim.get_spins()
    assert spins.shape == (64,)  # n_systems * n_spins
    r = sim.sample(8, "metropolis", pt_interval=1, progress=lambda *a: None)
    assert np.isfinite(r["mags2"]).all()
    assert int(sim.state["counter"]) == 12  # 4 interrupted + 8 completed

    whole = _sim()
    whole.sample(4, "metropolis", pt_interval=1)
    whole.sample(8, "metropolis", pt_interval=1)
    np.testing.assert_array_equal(sim.get_spins(), whole.get_spins())
    assert torch.equal(sim.state["system_ids"], whole.state["system_ids"])


def test_sigint_during_a_chunk_is_deferred():
    from peapods_tpu_torch.engine.simulation import _defer_sigint

    reached_end = []
    with pytest.raises(KeyboardInterrupt):
        with _defer_sigint():
            signal.raise_signal(signal.SIGINT)
            reached_end.append(True)  # the body finishes before the raise
    assert reached_end == [True]


def test_phase_scope_is_a_no_op_outside_a_profiler():
    a, b = profiling.phase_scope("sweep"), profiling.phase_scope("measure")
    assert a is b
    with a:
        pass


def test_trace_holds_the_phase_scopes(tmp_path):
    with profiling.trace(tmp_path):
        assert profiling.phase_scope("sweep") is not profiling._NO_SCOPE
        _sim().sample(8, "metropolis", pt_interval=1)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name", "") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert {n for n in names if n.startswith("peapods/")} == {"peapods/sweep",
                                                              "peapods/measure"}
