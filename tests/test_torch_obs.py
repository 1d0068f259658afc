"""The port's telemetry (``repro_torch.obs``, a copy of ``repro.obs``),
mirroring ``tests/test_obs.py`` apart from its snapshot events
(``test_torch_snapshot.py``): ``percentile`` equal to NumPy's; histogram bucket edges and exact
percentiles; the rolling median; the registry, the Prometheus text and a
live scrape; the Chrome trace; the facade's delta sync and periodic
report.  The port's ``percentile``, ``Histogram``, ``render`` and
``TraceSink`` give the reference's output on the same inputs.  On the
engine, observability on is token-identical to off, adds no capture, and
reads no device tensor: its counters agree with the tokens emitted, and
fault firings land on the trace."""
import json
import math
import urllib.request

import numpy as np
import pytest
import torch

from repro import obs as ref_obs

from repro_torch.obs import (Histogram, MetricsRegistry, MetricsServer,
                             Observability, RollingWindow, TraceSink,
                             percentile, percentile_summary, render)
from repro_torch.serving import (ContinuousEngine, Fault, FaultPlan,
                                 SamplingParams, SpecConfig,
                                 stable_trace_counts)
from repro_torch.serving.faults import CANCEL_SPEC, PAGE_EXHAUSTION
from repro_torch.serving.sampling import RequestMetrics

from torch_parity import configs, sparse_params


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_percentile_matches_numpy_and_the_reference():
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 7, 100, 101):
        vals = rng.normal(size=n).tolist()
        for q in (0, 1, 25, 50, 75, 90, 99, 99.9, 100):
            got = percentile(vals, q)
            assert got == float(np.percentile(vals, q)), (n, q)
            assert got == ref_obs.percentile(vals, q)


def test_percentile_edge_cases():
    with pytest.raises(ValueError):
        percentile([], 50)
    with pytest.raises(ValueError):
        percentile([1.0], 101)
    with pytest.raises(ValueError):
        percentile([1.0], -1)
    assert percentile([3.0], 99) == 3.0
    assert percentile([1.0, 2.0], 50) == 1.5
    s = percentile_summary([0.1, None, 0.3, None, 0.2], qs=(50,), scale=1e3)
    assert s == {"count": 3, "p50": pytest.approx(200.0)}
    assert percentile_summary([None])["p50"] is None


def test_histogram_edges_percentiles_and_reference_parity():
    h, r = Histogram(buckets=(1.0, 2.0)), ref_obs.Histogram(buckets=(1.0, 2.0))
    for v in (0.5, 1.0, 1.5, 2.0, 99.0):
        h.observe(v)
        r.observe(v)
    assert h.cumulative_buckets() == [(1.0, 2), (2.0, 4), (math.inf, 5)]
    assert h.cumulative_buckets() == r.cumulative_buckets()
    vals = np.random.default_rng(1).exponential(0.05, size=500)
    h, r = Histogram(), ref_obs.Histogram()
    for v in vals:
        h.observe(float(v))
        r.observe(float(v))
    assert h.exact
    for q in (50, 90, 99):
        assert h.percentile(q) == pytest.approx(
            float(np.percentile(vals, q)), rel=1e-12)
    assert h.snapshot() == r.snapshot()
    assert Histogram().percentile(50) is None
    for bad in ((), (2.0, 1.0), (1.0, 1.0)):
        with pytest.raises(ValueError):
            Histogram(buckets=bad)


def test_histogram_reservoir_is_deterministic_and_bounded():
    a = Histogram(buckets=(1.0,), max_samples=16, seed=3)
    r = ref_obs.Histogram(buckets=(1.0,), max_samples=16, seed=3)
    for i in range(200):
        a.observe(i * 0.01)
        r.observe(i * 0.01)
    assert not a.exact and len(a._samples) == 16
    assert a._samples == r._samples              # the same seeded reservoir
    assert a.count == 200


def test_rolling_window_median_and_eviction():
    w = RollingWindow(size=3)
    assert w.median() is None and w.mean() is None
    w.push(10.0)
    w.push(30.0)
    assert w.median() == 20.0
    w.push(20.0)
    w.push(1000.0)                               # evicts the 10.0
    assert w.median() == 30.0 and len(w) == 3


# ---------------------------------------------------------------------------
# registry + exporters
# ---------------------------------------------------------------------------

def _fill(reg):
    reg.counter("req_total", "requests", reason="stop").inc(4)
    reg.counter("req_total", reason="shed").inc()
    reg.gauge("depth", "queue").set(7)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0, 0.1):
        h.observe(v)


def test_registry_and_prometheus_render_match_the_reference():
    r = MetricsRegistry()
    c1 = r.counter("x_total", "help", reason="stop")
    assert r.counter("x_total", reason="stop") is c1
    with pytest.raises(ValueError):
        r.gauge("x_total")
    with pytest.raises(ValueError):
        r.counter("bad name")
    with pytest.raises(ValueError):
        c1.inc(-1)
    got, ref = MetricsRegistry(), ref_obs.MetricsRegistry()
    _fill(got)
    _fill(ref)
    text = render(got)
    assert text == ref_obs.render(ref)
    assert 'req_total{reason="stop"} 4' in text
    assert 'lat_seconds_bucket{le="+Inf"} 4' in text
    assert "lat_seconds_count 4" in text and text.endswith("\n")
    assert got.snapshot() == ref.snapshot()


def test_metrics_server_live_scrape():
    r = MetricsRegistry()
    r.counter("up_total").inc(2)
    srv = MetricsServer(r, port=0).start()
    try:
        with urllib.request.urlopen(srv.url, timeout=5) as resp:
            assert resp.headers["Content-Type"].startswith("text/plain")
            assert "up_total 2" in resp.read().decode()
        r.counter("up_total").inc()
        with urllib.request.urlopen(srv.url, timeout=5) as resp:
            assert "up_total 3" in resp.read().decode()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://{srv.host}:{srv.port}/nope", timeout=5)
    finally:
        srv.close()


def test_trace_sink_matches_the_reference(tmp_path):
    files = []
    for cls in (TraceSink, ref_obs.TraceSink):
        p = tmp_path / f"{cls.__module__}.json"
        t = cls(str(p))
        t.process_name(0, "engine")
        t.complete("tick", 10.0, 0.25, tid=0, args={"n": 1})
        t.instant("fault:x", 10.1, tid=0)
        t.counter("load", 10.2, {"queue": 3})
        t.close()
        t.close()                                # idempotent
        files.append(p.read_text())
    assert files[0] == files[1]
    evs = json.loads(files[0])
    assert [e["ph"] for e in evs] == ["M", "X", "i", "C"]
    assert evs[1]["ts"] == 0.0 and evs[1]["dur"] == pytest.approx(0.25e6)


def test_observability_delta_sync_and_report():
    lines = []
    obs = Observability(report_every=1.0, report_fn=lines.append)
    counters = {"shed": 0, "timeout": 0}
    obs.tick(start=0.0, now=0.1, tick_no=1, committed=3, queue_depth=2,
             active=1, slots=4, counters=counters, spec_hist=[0, 2, 0])
    counters["shed"] = 2
    obs.tick(start=0.1, now=0.2, tick_no=2, committed=1, queue_depth=0,
             active=1, slots=4, counters=counters, spec_hist=[0, 2, 1])
    s = obs.snapshot()
    assert s["repro_engine_ticks_total"] == 2.0
    assert s["repro_tokens_committed_total"] == 4.0
    assert s['repro_lifecycle_events_total{event="shed"}'] == 2.0
    assert s['repro_spec_windows_total{accepted="1"}'] == 2.0
    assert s['repro_spec_windows_total{accepted="2"}'] == 1.0
    assert lines == [lines[0]] and lines[0].startswith("[obs]")
    line = obs.report_line()
    assert "ticks=2" in line and "shed=2" in line


def test_request_metrics_ttft_split_and_tpot():
    m = RequestMetrics(arrival_time=1.0, first_token_time=4.0,
                       finished_time=10.0, decode_ticks=6,
                       num_generated=7, admitted_time=3.0)
    assert (m.queue_time, m.prefill_time, m.ttft) == (2.0, 1.0, 3.0)
    assert m.tpot == pytest.approx(1.0) and m.e2e_latency == 9.0


# ---------------------------------------------------------------------------
# the engine with observability on
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs("float32", kv_k_sparsity=0.3, kv_v_sparsity=0.5,
                         kv_tail=16)
    return tcfg, sparse_params(jcfg, tcfg)[1]


HOST_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
              "__float__", "__index__")


@pytest.mark.parametrize("overlap,spec", [(False, 0), (True, 3)],
                         ids=["serial", "overlap-k3"])
def test_obs_on_is_token_identical_and_adds_no_capture(
        setup, tmp_path, monkeypatch, overlap, spec):
    """Greedy tokens with obs on equal obs off; the captures and their
    replays are the same; the counters agree with the tokens emitted; and
    no obs hook ever reads a device tensor (every tensor read while a hook
    runs raises)."""
    cfg, params = setup
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (24,)).tolist() for _ in range(4)]
    sp = SamplingParams(max_new_tokens=8)

    def serve(obs):
        eng = ContinuousEngine(params, cfg, slots=2, max_tokens=80, bs=16,
                               prefill_chunk=16, device="cpu", obs=obs,
                               overlap=overlap,
                               spec=SpecConfig(k=spec) if spec else None)
        rids = [eng.submit(p, sp) for p in prompts]
        out = eng.run()
        return eng, {r: list(out[r].token_ids) for r in rids}

    base_eng, base = serve(None)
    guard = {"on": False}
    for name in HOST_READS:
        orig = getattr(torch.Tensor, name)

        def read(self, *a, _orig=orig, _name=name, **k):
            if guard["on"]:
                raise AssertionError(f"an obs hook read a tensor (.{_name})")
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, read)
    obs = Observability(trace_path=str(tmp_path / "t.json"))
    for hook in ("request_submitted", "request_finished", "prefill_chunk",
                 "decode_tick", "prefix_match", "fault", "tick"):
        fn = getattr(obs, hook)

        def guarded(*a, _fn=fn, **k):
            guard["on"] = True
            try:
                return _fn(*a, **k)
            finally:
                guard["on"] = False
        setattr(obs, hook, guarded)
    eng, toks = serve(obs)
    assert toks == base
    assert eng.trace_counts() == base_eng.trace_counts()
    assert eng.replay_counts() == base_eng.replay_counts()
    assert all(v <= 1 for v in stable_trace_counts(
        eng.trace_counts()).values())

    s = obs.snapshot()
    total = sum(len(t) for t in toks.values())
    assert s["repro_tokens_committed_total"] == float(total)
    assert s['repro_requests_finished_total{reason="length"}'] == 4.0
    for h in ("ttft", "tpot", "queue_time"):
        assert s[f"repro_{h}_seconds"]["count"] == 4
    assert s['repro_decode_tick_seconds{mode="%s"}'
             % ("spec" if spec else "plain")]["count"] > 0
    obs.close()
    names = {e["name"] for e in json.loads((tmp_path / "t.json").read_text())}
    assert {"tick", "verify" if spec else "decode", "prefill_chunk",
            "queued", "prefill", "submit", "finish:length",
            "engine_load"} <= names


def test_obs_traces_faults(setup, tmp_path):
    """Fault firings reach the registry and the trace through
    ``FaultPlan.on_fire``; a cancel lands as ``finish:cancelled``."""
    cfg, params = setup
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (32,)).tolist() for _ in range(3)]
    plan = FaultPlan([Fault(PAGE_EXHAUSTION, 2), Fault(CANCEL_SPEC, 4)])
    obs = Observability(trace_path=str(tmp_path / "t.json"))
    eng = ContinuousEngine(params, cfg, slots=2, max_tokens=96, bs=16,
                           prefill_chunk=16, paged=True, faults=plan,
                           obs=obs, spec=SpecConfig(k=3), device="cpu")
    for p in prompts:
        eng.submit(p, SamplingParams(max_new_tokens=6))
    eng.run()
    assert plan.exhausted()
    obs.close()
    s = obs.snapshot()
    assert s['repro_fault_injections_total{site="page-exhaustion"}'] == 1.0
    assert s['repro_fault_injections_total{site="cancel-spec"}'] == 1.0
    assert s['repro_requests_finished_total{reason="cancelled"}'] == 1.0
    assert s["repro_trie_lookup_blocks_total"] > 0
    assert s['repro_lifecycle_events_total{event="deferred"}'] >= 1.0
    names = {e["name"] for e in
             json.loads((tmp_path / "t.json").read_text())}
    assert {"fault:page-exhaustion", "fault:cancel-spec",
            "finish:cancelled"} <= names
