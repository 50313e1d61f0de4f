"""Terminal progress reporting for long sample() runs.

The port's own copy of ``peapods_tpu/utils/progress.py``: a single
rewriting stderr line with sweep counts, rate, and ETA, updated at chunk
granularity (the engine hands the host back control only between chunks).
"""

from __future__ import annotations

import sys
import time

__all__ = ["ProgressPrinter"]


class ProgressPrinter:
    """Callable progress(s, total) printing a rewriting status line."""

    def __init__(self, stream=None, min_interval=0.25):
        self.stream = stream if stream is not None else sys.stderr
        self.min_interval = min_interval
        self.start = time.perf_counter()
        self._last = 0.0
        self._done = False

    def __call__(self, done: int, total: int) -> None:
        now = time.perf_counter()
        if done < total and now - self._last < self.min_interval:
            return
        self._last = now
        elapsed = now - self.start
        rate = done / elapsed if elapsed > 0 else 0.0
        eta = (total - done) / rate if rate > 0 else float("inf")
        width = 32
        filled = int(width * done / max(total, 1))
        bar = "=" * filled + ">" + " " * (width - filled)
        self.stream.write(
            f"\rsweeps [{bar[:width]}] {done}/{total} "
            f"[{elapsed:6.1f}s < {eta:6.1f}s, {rate:8.1f}/s]"
        )
        if done >= total and not self._done:
            self.stream.write("\n")
            self._done = True
        self.stream.flush()
