"""Profiling hooks: named scopes for the loop phases and a trace context.

The port's counterpart of ``peapods_tpu/utils/profiling.py``.  The chunk
runners (``engine/loop.py``) mark their phases with :func:`phase_scope`
(``"sweep"`` and ``"measure"``, the reference's two names), which a
profiler shows as ``peapods/<name>`` ranges around the phase's kernel
launches; :func:`trace` captures a Chrome trace of a block::

    from peapods_tpu_torch.utils.profiling import trace
    with trace("/tmp/trace"):
        model.sample(...)

The scopes also reach Nsight Systems as NVTX ranges under
``torch.autograd.profiler.emit_nvtx()``.  With no profiler running a scope
is a shared no-op context: ``record_function`` would enter a dispatcher op
on every call.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch

__all__ = ["trace", "phase_scope"]

_NO_SCOPE = contextlib.nullcontext()


def phase_scope(name: str):
    """Range ``peapods/<name>`` for one loop phase while a profiler runs
    (:func:`trace`, ``torch.profiler.profile`` or ``emit_nvtx``); the
    shared no-op context otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(f"peapods/{name}")
    return _NO_SCOPE


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (host activity, and the device's where
    CUDA is present) and write it, also when the block raises, as a Chrome
    trace ``peapods.<pid>.<ns>.pt.trace.json`` into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        with prof:
            yield
    finally:
        out = Path(log_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(
            str(out / f"peapods.{os.getpid()}.{time.time_ns()}.pt.trace.json"))
