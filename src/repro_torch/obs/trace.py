"""Request-lifecycle tracing in the Chrome trace-event format (a copy of
``repro.obs.trace``).

One JSON event per line; the finished file is a valid JSON array that
loads directly in ``chrome://tracing`` or https://ui.perfetto.dev (both
also tolerate a truncated file from a crashed process, since each line
is a complete event).  Format reference:
https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU

Layout convention used by :class:`repro_torch.obs.Observability`:

* ``pid 0`` ("engine"): tick spans on ``tid 0``, device-step spans
  (decode / verify / prefill-chunk) on ``tid 1``, counter tracks and
  fault/snapshot instants on ``tid 0``.
* ``pid 1`` ("requests"): one row per request id with ``queued`` /
  ``prefill`` / ``decode`` spans and ``submit`` / ``finish:<reason>``
  instants.

Timestamps are **seconds in** (whatever clock the engine's scheduler
uses — ``time.monotonic`` in production, a fake in tests) and
microseconds-on-the-page out, rebased to the first event so traces start
at t=0.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, Optional

__all__ = ["TraceSink"]

PID_ENGINE = 0
PID_REQUESTS = 1


class TraceSink:
    """Append-only trace-event writer.  Thread-safe; cheap enough to call
    from the tick loop (one ``json.dumps`` + buffered write per event)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._fh = open(path, "w")
        self._fh.write("[")
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        self._first = True
        self._closed = False
        self.events_written = 0

    def _us(self, t: float) -> float:
        if self._t0 is None:
            self._t0 = t
        return (t - self._t0) * 1e6

    def _emit(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if self._closed:
                return
            self._fh.write("" if self._first else ",")
            self._fh.write("\n")
            json.dump(ev, self._fh, separators=(",", ":"))
            self._first = False
            self.events_written += 1

    # -- event kinds ----------------------------------------------------

    def complete(self, name: str, start: float, dur: float, *,
                 pid: int = PID_ENGINE, tid: int = 0, cat: str = "engine",
                 args: Optional[Dict[str, Any]] = None) -> None:
        """"X" span: ``start``/``dur`` in seconds."""
        ev: Dict[str, Any] = {"name": name, "ph": "X", "cat": cat,
                              "ts": self._us(start), "dur": dur * 1e6,
                              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name: str, t: float, *, pid: int = PID_ENGINE,
                tid: int = 0, cat: str = "engine",
                args: Optional[Dict[str, Any]] = None) -> None:
        ev: Dict[str, Any] = {"name": name, "ph": "i", "s": "t",
                              "cat": cat, "ts": self._us(t),
                              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name: str, t: float, values: Dict[str, float], *,
                pid: int = PID_ENGINE) -> None:
        """"C" track: Perfetto draws one stacked area chart per name."""
        self._emit({"name": name, "ph": "C", "ts": self._us(t),
                    "pid": pid, "tid": 0, "args": values})

    def process_name(self, pid: int, name: str) -> None:
        self._emit({"name": "process_name", "ph": "M", "pid": pid,
                    "tid": 0, "args": {"name": name}})

    def thread_name(self, pid: int, tid: int, name: str) -> None:
        self._emit({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": name}})

    # -- lifecycle ------------------------------------------------------

    def flush(self) -> None:
        with self._lock:
            if not self._closed:
                self._fh.flush()

    def close(self) -> None:
        """Terminate the JSON array and close the file (idempotent)."""
        with self._lock:
            if self._closed:
                return
            self._fh.write("\n]\n")
            self._fh.close()
            self._closed = True
