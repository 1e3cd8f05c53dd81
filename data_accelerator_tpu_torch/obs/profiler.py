"""On-demand ``torch.profiler`` surface: ``POST /profile?seconds=N``.

A live host arms a profiler capture on demand through its observability
port, captures for N seconds while batches keep flowing, and the capture
lands beside the flight recorder:

- ``POST <host>/profile?seconds=N`` (obs/exposition.py) starts a
  capture and returns its path once the profiler runs; the window
  closes by itself after N seconds.
- every finished capture is drained by the streaming host at the next
  batch finish and recorded as a ``profiler/capture`` span inside that
  batch's trace (so ``obs trace <batch>`` shows which capture overlapped
  which batches) and counted by the ``Profiler_Captures_Count`` series.
- ``python -m data_accelerator_tpu_torch.obs profile <url>`` drives it
  from a terminal. A capture directory holds ``trace.json``, a Chrome
  trace (``chrome://tracing``, Perfetto), with the card's kernels and
  the CPU ops of every thread of the process.

Copy of the JAX package's ``obs/profiler.py`` over ``torch.profiler``.
Differences:

- Each capture has one thread of its own that starts the profiler,
  waits out the window, stops it and exports the trace. A
  ``torch.profiler`` session stopped on another thread than the one that
  started it can crash the process, and the reference starts on the
  HTTP handler's thread and stops on a timer's.
- The profiler records every thread's CPU ops
  (``_ExperimentalConfig(profile_all_threads=True)``, where this torch
  has it): the host's dispatch, decode-ahead and landing threads are
  not the capture's. While it runs, the batch trace's spans open
  profiler ranges of their names (``obs/tracing.py``), so the timeline
  shows each thread's stages.
- Activities: the CPU, and CUDA when the host runs on a card.

No-op posture: where the profiler cannot start (no ``torch.profiler``,
or another profiler of the process is running) the surface reports the
error, the endpoint answers with it, and nothing else changes —
profiling is diagnostics, never load-bearing.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional

from . import tracing

logger = logging.getLogger(__name__)

DEFAULT_SECONDS = 5.0
MAX_SECONDS = 120.0
# how long ``start`` waits for the capture thread's profiler to run
START_TIMEOUT_S = 60.0
TRACE_FILE = "trace.json"


def profiler_available() -> bool:
    """True when this process can start a ``torch.profiler`` capture."""
    try:
        import torch.profiler

        return hasattr(torch.profiler, "profile")
    except Exception:  # noqa: BLE001 — any import failure = unavailable
        return False


def _new_profile(cuda: bool):
    """A ``torch.profiler.profile`` over the CPU (and the card), every
    thread's ops recorded where this torch can."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    try:
        from torch.profiler import _ExperimentalConfig

        config = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return profile(activities=activities)
    return profile(activities=activities, experimental_config=config)


class ProfilerSurface:
    """One host's on-demand capture state: at most one capture at a
    time, each on its own thread, and a drain queue of finished captures
    for the host to stitch into batch traces."""

    def __init__(self, base_dir: str, flow: str = "", cuda: bool = False):
        self.base_dir = base_dir
        self.flow = flow
        self.cuda = cuda
        self.captures_count = 0
        self._seq = 0
        self._active: Optional[dict] = None
        self._thread: Optional[threading.Thread] = None
        self._close: Optional[threading.Event] = None
        self._finished: List[Dict] = []
        self._lock = threading.Lock()

    @property
    def available(self) -> bool:
        return profiler_available()

    def active(self) -> Optional[dict]:
        with self._lock:
            return dict(self._active) if self._active else None

    def start(self, seconds: float = DEFAULT_SECONDS) -> dict:
        """Arm a capture for ``seconds``; returns
        ``{path, seconds, active}`` once the profiler runs, or
        ``{error}`` (already capturing / profiler unavailable / the
        profiler failed to start)."""
        seconds = min(max(float(seconds), 0.1), MAX_SECONDS)
        if not self.available:
            return {"error": "torch.profiler unavailable in this process"}
        with self._lock:
            if self._active is not None:
                return {
                    "error": "capture already in progress",
                    "path": self._active["path"],
                }
            self._seq += 1
            path = os.path.join(self.base_dir, f"capture-{self._seq:04d}")
            os.makedirs(path, exist_ok=True)
            active = {"path": path, "seconds": seconds}
            started = threading.Event()
            close = threading.Event()
            thread = threading.Thread(
                target=self._capture, args=(active, started, close),
                name="profiler-capture", daemon=True,
            )
            self._active, self._thread, self._close = active, thread, close
            thread.start()
        started.wait(START_TIMEOUT_S)
        if "error" in active:
            thread.join(timeout=START_TIMEOUT_S)
            return {"error": active["error"]}
        logger.info("profiler capture armed for %.1fs -> %s", seconds, path)
        return {"path": path, "seconds": seconds, "active": True}

    def _capture(self, active: dict, started: threading.Event,
                 close: threading.Event) -> None:
        """The capture thread: start, wait out the window (or a
        ``stop``), stop, export, queue for the drain."""
        try:
            prof = _new_profile(self.cuda)
            prof.start()
        except Exception as e:  # noqa: BLE001 — diagnostics only
            logger.warning("profiler start failed: %s", e)
            active["error"] = f"profiler start failed: {e}"
            with self._lock:
                self._active = None
            started.set()
            return
        active["startedTs"] = time.time()
        tracing.PROFILER_RANGES.set()
        started.set()
        close.wait(active["seconds"])
        tracing.PROFILER_RANGES.clear()
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(active["path"], TRACE_FILE))
        except Exception as e:  # noqa: BLE001 — the capture may be torn
            logger.warning("profiler stop/export failed: %s", e)
        active["durationMs"] = round(
            (time.time() - active["startedTs"]) * 1000.0, 1
        )
        with self._lock:
            self._active = None
            self.captures_count += 1
            self._finished.append(dict(active))
        logger.info("profiler capture written to %s", active["path"])

    def stop(self) -> Optional[str]:
        """Close the active capture and wait until its trace is written
        (idempotent); returns its path."""
        with self._lock:
            thread, close, self._thread, self._close = (
                self._thread, self._close, None, None
            )
            active = self._active
        if thread is None:
            return None
        close.set()
        thread.join()
        return None if active is None or "error" in active else active["path"]

    def drain_finished(self) -> List[Dict]:
        """Captures completed since the last drain — the host records
        each as a ``profiler/capture`` span event on the batch trace
        that drains it."""
        with self._lock:
            out, self._finished = self._finished, []
            return out
