"""On-demand, bounded ``torch.profiler`` captures for a live server.

``POST /debug/profile`` on the serving front end lands here: a
:class:`Profiler` owns a capture directory and runs one ``torch.profiler``
window at a time (host activity, and the CUDA devices' when there are
any). Two guard rails make it safe to expose on a production port (behind
the admin token):

* **bounded** — ``duration_s`` is clamped to ``max_seconds``;
* **exclusive** — one capture at a time per profiler: a second
  ``capture()`` while one runs raises :class:`ProfileInProgress`
  immediately (HTTP 409).

Each capture writes a Chrome trace, ``trace.json``, into a numbered
subdirectory (``capture-0001``, ...) of the base dir, viewable in
``chrome://tracing`` or Perfetto. The port's twin of the JAX package's
``repro.obs.profiling``, which captures with ``jax.profiler``.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional

__all__ = ["ProfileInProgress", "Profiler"]


class ProfileInProgress(RuntimeError):
    """A capture is already running."""


class Profiler:
    """Serialized, duration-clamped ``torch.profiler`` captures.

    ``base_dir`` is created on first use. ``capture()`` blocks the
    *calling* thread for the capture window (the HTTP front end calls it
    from the request handler thread, so the POST returns when the trace
    is on disk) while other threads keep serving; the profiler records
    their device work too.
    """

    def __init__(self, base_dir: str, *, max_seconds: float = 10.0):
        if max_seconds <= 0:
            raise ValueError(f"max_seconds={max_seconds} must be > 0")
        self.base_dir = base_dir
        self.max_seconds = float(max_seconds)
        self._lock = threading.Lock()  # non-reentrant: one capture at a time
        self._captures = 0

    @property
    def active(self) -> bool:
        """True while a capture window is open."""
        if self._lock.acquire(blocking=False):
            self._lock.release()
            return False
        return True

    def capture(self, duration_s: float,
                *, out_dir: Optional[str] = None) -> dict:
        """Run one bounded trace window; returns capture metadata
        (``dir``, ``trace``, ``duration_s``, ``capture``).

        Raises :class:`ProfileInProgress` when a capture is already
        running, ``ValueError`` on a non-positive duration. Durations
        beyond ``max_seconds`` are clamped, not rejected.
        """
        duration_s = float(duration_s)
        if duration_s <= 0:
            raise ValueError(f"duration_s={duration_s} must be > 0")
        duration_s = min(duration_s, self.max_seconds)
        if not self._lock.acquire(blocking=False):
            raise ProfileInProgress(
                "a profiler capture is already running; retry when it ends")
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            self._captures += 1
            n = self._captures
            d = out_dir or os.path.join(self.base_dir, f"capture-{n:04d}")
            os.makedirs(d, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as prof:
                time.sleep(duration_s)
            trace = os.path.join(d, "trace.json")
            prof.export_chrome_trace(trace)
            return {"dir": d, "trace": trace, "duration_s": duration_s,
                    "capture": n}
        finally:
            self._lock.release()
