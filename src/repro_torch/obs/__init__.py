"""``repro_torch.obs``: host-side engine telemetry (a copy of
``repro.obs``, pure stdlib, the same series names and formats).

The serving engine takes an optional :class:`Observability` and calls its
hooks only from host code: at the tick boundary, at the overlapped
pipeline's one token read and on the host-only submit and cancel paths.
Nothing in this package imports numpy or torch, and every value it is
handed is a plain int, float or list read from the engine's host mirrors,
so observability cannot add a device sync: the captured entries, their
capture counts and the token streams are identical with it on or off
(``tests/test_torch_obs.py``).

Components:

* :class:`~repro_torch.obs.metrics.MetricsRegistry`: counters, gauges and
  exact-percentile latency histograms, ``registry.snapshot()`` dict.
* :class:`~repro_torch.obs.trace.TraceSink`: request-lifecycle spans in
  the Chrome trace-event format (``chrome://tracing`` / Perfetto).
* :class:`~repro_torch.obs.prometheus.MetricsServer`: background-thread
  ``/metrics`` scrape endpoint; :func:`~repro_torch.obs.prometheus.render`
  for the text exposition itself.
* :class:`Observability`: the facade the engine is wired to.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .metrics import (
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    RollingWindow,
    percentile,
    percentile_summary,
)
from .prometheus import CONTENT_TYPE, MetricsServer, render
from .trace import PID_ENGINE, PID_REQUESTS, TraceSink

__all__ = [
    "Observability",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "RollingWindow",
    "percentile",
    "percentile_summary",
    "DEFAULT_LATENCY_BUCKETS",
    "TraceSink",
    "MetricsServer",
    "render",
    "CONTENT_TYPE",
    "PID_ENGINE",
    "PID_REQUESTS",
]


class Observability:
    """The engine-facing telemetry facade.

    Every hook is a handful of dict/float operations; the engine guards
    each call site with ``if self._obs is not None`` so the obs-off path
    does literally nothing.  Timestamps are whatever clock the engine's
    scheduler runs on (``time.monotonic`` by default, fakes in tests) —
    one timeline, never mixed.

    Monotonic external counters (the engine's ``fault_counters``, the
    allocator's eviction count, the spec accepted-length histogram) are
    *synced by delta* at each tick rather than incremented at their
    origin, so the engine's existing accounting stays the single source
    of truth and obs stays strictly read-only.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 trace_path: Optional[str] = None,
                 report_every: float = 0.0,
                 report_fn: Callable[[str], None] = print) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        self.trace = TraceSink(trace_path) if trace_path else None
        self.report_every = report_every
        self._report_fn = report_fn
        self._last_report: Optional[float] = None

        r = self.registry
        self._ticks = r.counter(
            "repro_engine_ticks_total", "engine steps executed")
        self._tokens = r.counter(
            "repro_tokens_committed_total",
            "tokens committed across all requests (prefill first tokens "
            "and accepted speculative windows included)")
        self._submitted = r.counter(
            "repro_requests_submitted_total", "requests submitted")
        self._queue_depth = r.gauge(
            "repro_queue_depth", "requests waiting for a slot")
        self._active = r.gauge(
            "repro_active_slots", "slots holding a live request")
        self._slots = r.gauge("repro_slots_total", "pool slot count")
        self._free_pages = r.gauge(
            "repro_page_pool_free_blocks",
            "free + revivable physical pages (paged pool only)")
        self._phys = r.gauge(
            "repro_page_pool_blocks_total", "physical page count")
        self._trie_blocks = r.gauge(
            "repro_prefix_trie_blocks", "blocks content-addressed in the "
            "prefix trie")
        self._tick_h = r.histogram(
            "repro_tick_seconds", "engine step wall time")
        self._ttft_h = r.histogram(
            "repro_ttft_seconds", "time to first token (queue + prefill)")
        self._tpot_h = r.histogram(
            "repro_tpot_seconds", "per-output-token latency after the "
            "first token")
        self._queue_h = r.histogram(
            "repro_queue_time_seconds", "submit -> slot admission")
        self._prefill_h = r.histogram(
            "repro_prefill_time_seconds", "admission -> first token")
        self._e2e_h = r.histogram(
            "repro_e2e_seconds", "submit -> finish")
        # live tok/s: rolling median of per-tick committed/duration
        self.tok_rate = RollingWindow(64)
        # delta-sync state for external monotonic counters
        self._synced: Dict[Any, float] = {}
        self._last: Dict[str, float] = {}
        self._named_req_rows: set = set()
        if self.trace is not None:
            self.trace.process_name(PID_ENGINE, "engine")
            self.trace.thread_name(PID_ENGINE, 0, "ticks")
            self.trace.thread_name(PID_ENGINE, 1, "device steps")
            self.trace.process_name(PID_REQUESTS, "requests")

    # -- delta sync -----------------------------------------------------

    def _sync_counter(self, name: str, help: str, value: float,
                      **labels: Any) -> None:
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        last = self._synced.get(key, 0.0)
        if value > last:
            self.registry.counter(name, help, **labels).inc(value - last)
            self._synced[key] = value
        elif value < last:      # source reset (fresh engine on one obs)
            self._synced[key] = value

    # -- request lifecycle ----------------------------------------------

    def request_submitted(self, rid: int, prompt_len: int,
                          now: float,
                          queue_depth: Optional[int] = None) -> None:
        self._submitted.inc()
        if queue_depth is not None:
            # submit-path refresh: the asyncio frontend submits between
            # ticks, where obs.tick cannot see a shed leave the gauge
            # stale; the engine passes the post-submit depth (a shed never
            # entered the queue, so the gauge and the shed counter agree)
            self._queue_depth.set(queue_depth)
        if self.trace is not None:
            if rid not in self._named_req_rows:
                self._named_req_rows.add(rid)
                self.trace.thread_name(PID_REQUESTS, rid, f"req {rid}")
            self.trace.instant("submit", now, pid=PID_REQUESTS, tid=rid,
                               cat="request", args={"prompt_len": prompt_len})

    def request_finished(self, out: Any, now: float) -> None:
        """``out`` is a ``RequestOutput`` (duck-typed: request_id,
        finish_reason, token_ids, metrics)."""
        m = out.metrics
        reason = out.finish_reason or "unknown"
        self.registry.counter(
            "repro_requests_finished_total", "finished requests by reason",
            reason=reason).inc()
        for h, v in ((self._ttft_h, m.ttft), (self._tpot_h, m.tpot),
                     (self._queue_h, m.queue_time),
                     (self._prefill_h, m.prefill_time),
                     (self._e2e_h, m.e2e_latency)):
            if v is not None:
                h.observe(v)
        if self.trace is None:
            return
        rid = out.request_id
        if rid not in self._named_req_rows:
            self._named_req_rows.add(rid)
            self.trace.thread_name(PID_REQUESTS, rid, f"req {rid}")
        end = m.finished_time if m.finished_time is not None else now
        admitted = m.admitted_time
        first = m.first_token_time
        if admitted is not None:
            self.trace.complete("queued", m.arrival_time,
                                admitted - m.arrival_time,
                                pid=PID_REQUESTS, tid=rid, cat="request")
        elif end > m.arrival_time:   # died in the queue (shed/timeout)
            self.trace.complete("queued", m.arrival_time,
                                end - m.arrival_time,
                                pid=PID_REQUESTS, tid=rid, cat="request")
        if admitted is not None and first is not None:
            self.trace.complete("prefill", admitted, first - admitted,
                                pid=PID_REQUESTS, tid=rid, cat="request")
        if first is not None:
            self.trace.complete("decode", first, end - first,
                                pid=PID_REQUESTS, tid=rid, cat="request",
                                args={"tokens": len(out.token_ids)})
        self.trace.instant(f"finish:{reason}", end, pid=PID_REQUESTS,
                           tid=rid, cat="request",
                           args={"tokens": len(out.token_ids)})

    # -- engine step internals -------------------------------------------

    def prefill_chunk(self, rid: int, slot: int, start: float, dur: float,
                      n_tokens: int, final: bool) -> None:
        self.registry.histogram(
            "repro_prefill_chunk_seconds",
            "one chunked-prefill host dispatch (the final chunk includes "
            "the first-token sync)").observe(dur)
        if self.trace is not None:
            self.trace.complete("prefill_chunk", start, dur, pid=PID_ENGINE,
                                tid=1, cat="device",
                                args={"rid": rid, "slot": slot,
                                      "tokens": n_tokens, "final": final})

    def decode_tick(self, start: float, dur: float, n_slots: int,
                    spec: bool, overlapped: bool = False) -> None:
        """One decode/verify window's device span.  Under the overlapped
        engine the span runs dispatch -> the one-tick-DELAYED sync, so it
        reflects true pipelined wall clock (host work only shows where it
        failed to hide behind the device); the metric keeps its mode label
        and the trace event gains an ``overlapped`` arg."""
        mode = "spec" if spec else "plain"
        self.registry.histogram(
            "repro_decode_tick_seconds",
            "decode dispatch through the token sync", mode=mode).observe(dur)
        if self.trace is not None:
            args: Dict[str, Any] = {"slots": n_slots}
            if overlapped:
                args["overlapped"] = True
            self.trace.complete("verify" if spec else "decode", start, dur,
                                pid=PID_ENGINE, tid=1, cat="device",
                                args=args)

    def prefix_match(self, hit_blocks: int, lookup_blocks: int) -> None:
        self.registry.counter(
            "repro_trie_hit_blocks_total",
            "prompt blocks served from the prefix trie").inc(hit_blocks)
        self.registry.counter(
            "repro_trie_lookup_blocks_total",
            "prompt blocks probed against the prefix trie"
        ).inc(lookup_blocks)
        if hit_blocks > 0:
            self.registry.counter(
                "repro_trie_hit_admissions_total",
                "admissions that reused at least one page").inc()

    def fault(self, site: str, tick: int, now: float) -> None:
        self.registry.counter(
            "repro_fault_injections_total",
            "seeded fault-plan firings by site", site=site).inc()
        if self.trace is not None:
            self.trace.instant(f"fault:{site}", now, pid=PID_ENGINE, tid=0,
                               cat="fault", args={"tick": tick})

    def snapshot_event(self, kind: str, start: float, dur: float,
                       pages: int) -> None:
        self.registry.counter(
            "repro_snapshots_total", "snapshot operations by kind",
            kind=kind).inc()
        if self.trace is not None:
            self.trace.complete(f"snapshot:{kind}", start, dur,
                                pid=PID_ENGINE, tid=0, cat="snapshot",
                                args={"pages": pages})

    # -- the tick-boundary sync point ------------------------------------

    def tick(self, *, start: float, now: float, tick_no: int, committed: int,
             queue_depth: int, active: int, slots: int,
             counters: Dict[str, int],
             free_blocks: Optional[int] = None, n_phys: int = 0,
             evictions: int = 0, trie_blocks: int = 0,
             spec_hist: Optional[Sequence[int]] = None) -> None:
        """Called once per engine step, after the step's releases flush.
        All arguments are plain host ints/floats/lists."""
        dur = now - start
        self._ticks.inc()
        self._tokens.inc(committed)
        self._tick_h.observe(dur)
        self._queue_depth.set(queue_depth)
        self._active.set(active)
        self._slots.set(slots)
        self._trie_blocks.set(trie_blocks)
        if free_blocks is not None:
            self._free_pages.set(free_blocks)
            self._phys.set(n_phys)
        if dur > 0 and committed > 0:
            self.tok_rate.push(committed / dur)
        for event, value in counters.items():
            self._sync_counter(
                "repro_lifecycle_events_total",
                "request-lifecycle / fault-tolerance events by kind",
                float(value), event=event)
        self._sync_counter(
            "repro_page_evictions_total",
            "LRU evictions of revivable pages", float(evictions))
        if spec_hist is not None:
            for accepted, windows in enumerate(spec_hist):
                if windows:
                    self._sync_counter(
                        "repro_spec_windows_total",
                        "speculative verify windows by accepted draft count",
                        float(windows), accepted=str(accepted))
        if self.trace is not None:
            self.trace.complete("tick", start, dur, pid=PID_ENGINE, tid=0,
                                cat="tick", args={"n": tick_no,
                                                  "committed": committed})
            track = {"queue": queue_depth, "active": active}
            if free_blocks is not None:
                track["free_pages"] = free_blocks
            self.trace.counter("engine_load", now, track)
        self._maybe_report(now)

    def _maybe_report(self, now: float) -> None:
        if not self.report_every:
            return
        if (self._last_report is not None
                and now - self._last_report < self.report_every):
            return
        self._last_report = now
        self._report_fn(self.report_line())

    def report_line(self) -> str:
        """The periodic one-line stdout report.

        All values here are plain Python floats (this package never holds
        a device value).
        """
        rate = self.tok_rate.median()
        lifecycle = {
            k: self._synced.get(
                ("repro_lifecycle_events_total", (("event", k),)), 0)
            for k in ("shed", "timeout", "cancelled")}
        parts = [
            f"ticks={self._ticks.value:.0f}",
            f"tok={self._tokens.value:.0f}",
            f"tok/s~{rate:.1f}" if rate is not None else "tok/s~n/a",
            f"queue={self._queue_depth.value:.0f}",
            f"active={self._active.value:.0f}/{self._slots.value:.0f}",
            f"shed={lifecycle['shed']:.0f}",
            f"timeout={lifecycle['timeout']:.0f}",
            f"cancelled={lifecycle['cancelled']:.0f}",
        ]
        if self._phys.value:
            parts.append(f"pages={self._free_pages.value:.0f}/"
                         f"{self._phys.value:.0f}")
        return "[obs] " + " ".join(parts)

    def snapshot(self) -> Dict[str, Any]:
        return self.registry.snapshot()

    def close(self) -> None:
        if self.trace is not None:
            self.trace.close()
