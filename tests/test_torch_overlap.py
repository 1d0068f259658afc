"""The port's overlapped ticks (``ContinuousEngine(overlap=True)``) against
its serial engine, mirroring ``tests/test_overlap.py``: greedy and seeded
tokens and logprobs identical, flat and paged, speculation off and on
(``k = 3``); one flat f32 case identical to the reference's overlapped
engine; one capture per forward entry across refreezes, admissions and
releases; the host reads a tick's tokens only in ``_sync_inflight``, once
a tick; ``quiesce`` drains the pipeline; and the in-flight window never
shares storage with the captured forward's static buffers, which the next
tick overwrites.  A cancel or a deadline that lands while a window is in
flight drops the victim's dispatched tokens and leaves the co-tenant
untouched; a shed is counted once, by the scheduler."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import SamplingParams as JaxParams

from repro_torch.obs import Observability
from repro_torch.serving import (CapturedEntry, ContinuousEngine,
                                 SamplingParams, SpecConfig,
                                 stable_trace_counts)

from torch_parity import configs, sparse_params


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The reduced model's ops are too small to split across threads: one
    intra-op thread runs this file faster alone and leaves the cores to
    the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    kw = dict(kv_k_sparsity=0.3, kv_v_sparsity=0.5, kv_tail=16)
    jcfg, tcfg = configs("float32", **kw)
    jparams, tparams = sparse_params(jcfg, tcfg)
    return jcfg, tcfg, jparams, tparams


def _prompts(vocab, seed=0, lens=(9, 17, 5, 23, 12)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).tolist() for n in lens]


def _engine(params, cfg, cls=ContinuousEngine, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_tokens", 96)
    kw.setdefault("bs", 16)
    kw.setdefault("prefill_chunk", 32)
    if cls is ContinuousEngine:
        kw.setdefault("device", "cpu")
    return cls(params, cfg, **kw)


def _staggered_wave(eng, prompts, sp):
    """Submit 2, tick 3 times, submit the rest: admissions, refreezes and
    releases land while a tick is in flight."""
    rids = [eng.submit(p, sp) for p in prompts[:2]]
    for _ in range(3):
        eng.step()
    rids += [eng.submit(p, sp) for p in prompts[2:]]
    out = eng.run()
    return {r: (list(out[r].token_ids), list(out[r].logprobs))
            for r in rids}


def _assert_drained(eng):
    assert eng._inflight is None and not eng._pending_release
    assert not eng.scheduler.active and not eng._blocks
    if eng._alloc is not None:                   # paged conservation
        assert not eng._reserved and not eng._slot_live.any()
        assert int(eng._alloc._ref.sum()) == 0
        assert int(eng.state["refcount"].sum()) == 0


def _entry_name(spec):
    return "verify" if spec else "decode"


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_overlap_token_identity(setup, spec, paged):
    _, cfg, _, params = setup
    prompts = _prompts(cfg.vocab)
    sp = SamplingParams(max_new_tokens=8)
    kw = dict(paged=paged, spec=SpecConfig(k=3) if spec else None)
    want = _staggered_wave(_engine(params, cfg, overlap=False, **kw),
                           prompts, sp)
    eng = _engine(params, cfg, overlap=True, **kw)
    assert _staggered_wave(eng, prompts, sp) == want
    traces = stable_trace_counts(eng.trace_counts())
    assert all(v <= 1 for v in traces.values()), traces
    assert traces[_entry_name(spec)] == 1
    _assert_drained(eng)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_overlap_sampled_identity(setup, spec):
    """Seeded sampling: a request's generator advances once per dispatched
    live tick, so the draws, the dropped ones of a finished request
    included, replay exactly."""
    _, cfg, _, params = setup
    prompts = _prompts(cfg.vocab, seed=3)
    sp = SamplingParams(max_new_tokens=8, temperature=0.8, top_k=20, seed=7)
    kw = dict(spec=SpecConfig(k=3) if spec else None)
    want = _staggered_wave(_engine(params, cfg, overlap=False, **kw),
                           prompts, sp)
    eng = _engine(params, cfg, overlap=True, **kw)
    got = _staggered_wave(eng, prompts, sp)
    assert got == want
    assert any(len(set(t)) > 1 for t, _ in got.values())   # really sampled
    _assert_drained(eng)


def test_overlap_matches_the_reference_overlapped_engine(setup):
    """Flat f32, greedy: the port's overlapped tokens equal the reference
    ``ContinuousEngine(overlap=True)``'s on the same weights."""
    jcfg, tcfg, jparams, tparams = setup
    prompts = _prompts(tcfg.vocab, lens=(9, 17, 12))
    ref = _staggered_wave(_engine(jparams, jcfg, JaxEngine, overlap=True),
                          [jnp.asarray(p, jnp.int32) for p in prompts],
                          JaxParams(max_new_tokens=8))
    got = _staggered_wave(_engine(tparams, tcfg, overlap=True), prompts,
                          SamplingParams(max_new_tokens=8))
    assert [t for t, _ in got.values()] == [t for t, _ in ref.values()]


@pytest.mark.parametrize("spec,paged", [(False, False), (True, True)],
                         ids=["plain-flat", "spec-paged"])
def test_one_capture_per_entry_across_the_lifecycle(setup, spec, paged):
    """Two waves through two slots on a 16-token ring: after every tick the
    engine holds at most one capture per entry, and the entry its ticks use
    is captured once, however many refreezes, admissions and releases came
    between."""
    _, cfg, _, params = setup
    eng = _engine(params, cfg, overlap=True, paged=paged,
                  spec=SpecConfig(k=3) if spec else None)
    refreezes, admitted, released = [0], [0], [0]
    pool_refreeze, flush = eng.pool.refreeze, eng._flush_releases

    def counting_refreeze(state, *a):
        refreezes[0] += 1
        return pool_refreeze(state, *a)

    def counting_flush():
        released[0] += len(set(eng._pending_release))
        flush()
    object.__setattr__(eng.pool, "refreeze", counting_refreeze)
    eng._flush_releases = counting_flush
    for wave in range(2):
        for p in _prompts(cfg.vocab, seed=wave, lens=(30, 7, 19)):
            eng.submit(p, SamplingParams(max_new_tokens=16))
            admitted[0] += 1
        while not eng.scheduler.done():
            eng.step()
            counts = stable_trace_counts(eng.trace_counts())
            assert all(v <= 1 for v in counts.values()), counts
        eng.quiesce()
    assert eng.trace_counts()[_entry_name(spec)] == 1
    assert refreezes[0] >= 2 and admitted[0] == 6 and released[0] == 6
    assert eng.replay_counts()[_entry_name(spec)] > 10
    _assert_drained(eng)


HOST_READS = ("tolist", "item", "__bool__", "__int__", "__float__",
              "__index__")


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_one_token_sync_per_tick(setup, monkeypatch, spec, paged):
    """Every host read of a tensor value during a tick is counted (the
    forward itself excluded: on the card it is one graph replay).  A tick
    that neither refreezes nor samples a first token from a final prefill
    chunk reads only inside ``_sync_inflight``, and commits one window
    there at most; over the run every dispatched tick is committed (or
    dropped) exactly once, the last by ``quiesce``."""
    _, cfg, _, params = setup
    where = {"on": False, "site": None, "reads": []}
    for name in HOST_READS:
        orig = getattr(torch.Tensor, name)

        def read(self, *a, _orig=orig, **k):
            if where["on"]:
                where["reads"].append(where["site"])
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, read)
    run = CapturedEntry.run

    def quiet_run(self):
        if "mask" not in self.inputs:        # not a decode or verify panel
            return run(self)
        on, where["on"] = where["on"], False
        try:
            return run(self)
        finally:
            where["on"] = on
    monkeypatch.setattr(CapturedEntry, "run", quiet_run)

    eng = _engine(params, cfg, overlap=True, paged=paged, prefill_chunk=16,
                  spec=SpecConfig(k=3) if spec else None)
    sync, commits = eng._sync_inflight, [0]

    def counted_sync(events):
        if eng._inflight is not None:
            commits[0] += 1
        site, where["site"] = where["site"], "sync"
        try:
            sync(events)
        finally:
            where["site"] = site
    eng._sync_inflight = counted_sync
    refreeze, prefill = eng._refreeze_tick, eng._prefill_tick
    busy = set()

    def noted_refreeze(*a):
        full = any(eng._tail_len[s] >= eng.pool.tail
                   for s in range(eng.pool.slots))
        if full:
            busy.add("refreeze")
        return refreeze(*a)

    def noted_prefill(events):
        req = eng.scheduler.next_prefill()
        if req is not None and \
                len(req.prompt) - req.prefill_done <= eng.pool.bs:
            busy.add("final prefill")       # at most one chunk remains
        return prefill(events)
    eng._refreeze_tick, eng._prefill_tick = noted_refreeze, noted_prefill
    sp = SamplingParams(max_new_tokens=10, temperature=0.7, seed=5)
    for p in _prompts(cfg.vocab, lens=(9, 40, 23)):
        eng.submit(p, sp)
    plain_ticks = 0
    while not eng.scheduler.done():
        busy.clear()
        where.update(on=True, site=None, reads=[])
        before = commits[0]
        eng.step()
        where["on"] = False
        if not busy:
            plain_ticks += 1
            assert set(where["reads"]) <= {"sync"}, where["reads"]
            assert commits[0] - before <= 1
    eng.quiesce()
    assert plain_ticks > 10
    ticks = eng.replay_counts()
    assert commits[0] == ticks.get("decode", 0) + ticks.get("verify", 0)
    _assert_drained(eng)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_quiesce_drains_the_pipeline(setup, spec):
    """``quiesce`` mid-traffic commits the in-flight window and flushes the
    releases; the engine then runs on to the serial engine's tokens."""
    _, cfg, _, params = setup
    prompts = _prompts(cfg.vocab, seed=2, lens=(9, 17, 23))
    sp = SamplingParams(max_new_tokens=8)
    kw = dict(spec=SpecConfig(k=3) if spec else None)
    serial = _engine(params, cfg, **kw)
    rids = [serial.submit(p, sp) for p in prompts]
    want = {r: list(o.token_ids) for r, o in serial.run().items()}
    eng = _engine(params, cfg, overlap=True, **kw)
    rids = [eng.submit(p, sp) for p in prompts]
    for _ in range(40):
        eng.step()
        if eng._inflight is not None and any(
                r.generated for r in eng.scheduler.active.values()):
            break
    assert eng._inflight is not None
    live = {r.rid: len(r.generated) for r in eng.scheduler.active.values()}
    events = eng.quiesce()
    assert eng._inflight is None and not eng._pending_release
    assert events and all(live.get(e.request_id, -1) < len(e.token_ids)
                          for e in events)
    assert eng.quiesce() == []                  # idempotent once drained
    got = {r: list(o.token_ids) for r, o in eng.run().items()}
    assert got == want and sorted(got) == sorted(rids)
    _assert_drained(eng)


def test_inflight_window_shares_no_storage_with_the_graph(setup):
    """The in-flight tokens and logprobs are the sampler's fresh tensors,
    never views of the captured forward's static buffers: the next tick's
    replay overwrites those before the window is committed."""
    _, cfg, _, params = setup
    for spec in (None, SpecConfig(k=3)):
        eng = _engine(params, cfg, overlap=True, spec=spec)
        for p in _prompts(cfg.vocab):
            eng.submit(p, SamplingParams(max_new_tokens=6))
        seen = 0
        while not eng.scheduler.done():
            eng.step()
            rec = eng._inflight
            if rec is None:
                continue
            fwd = eng._entries[_entry_name(spec)]
            static = {t.untyped_storage().data_ptr()
                      for t in (fwd.out, *fwd.inputs.values())}
            held = [rec[k] for k in ("tok", "logp", "ncommit", "chain")
                    if rec.get(k) is not None]
            assert all(t.untyped_storage().data_ptr() not in static
                       for t in held)
            seen += 1
        eng.quiesce()
        assert seen > 5


def test_overlap_serves_the_launcher_config(setup):
    """The launcher's stream mode (overlapped by default) on a reduced
    config with uneven lengths: every request finishes with its budget, the
    decode and refreeze entries are captured once and the prefill chunk
    once per width class."""
    _, cfg, _, params = setup
    cfg = dataclasses.replace(cfg, kv_tail=32)
    eng = _engine(params, cfg, overlap=True, max_tokens=160, bs=0,
                  prefill_chunk=None)
    rng = np.random.default_rng(4)
    rids = [eng.submit(rng.integers(0, cfg.vocab, (n,)).tolist(),
                       SamplingParams(max_new_tokens=m))
            for n, m in ((24, 9), (48, 14), (31, 6))]
    out = eng.run()
    assert [len(out[r].token_ids) for r in rids] == [9, 14, 6]
    # bs = 32: the unchunked prompts take the chunk width classes 32 and 64
    assert eng.trace_counts() == {"decode": 1, "prefill_chunk": 2,
                                  "refreeze": 1, "release": 1,
                                  "set_lane": 1}
    _assert_drained(eng)


# ---------------------------------------------------------------------------
# lifecycle races against the in-flight tick
# ---------------------------------------------------------------------------

class FakeClock:
    """Injected monotonic clock: tests advance time, nothing sleeps."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _step_until_inflight(eng, rid, min_tokens=2, max_ticks=100):
    """Tick until ``rid`` has committed ``min_tokens`` and a dispatched
    window is in flight, so the next lifecycle event races it."""
    for _ in range(max_ticks):
        eng.step()
        req = next((r for r in eng.scheduler.active.values()
                    if r.rid == rid), None)
        if (req is not None and len(req.generated) >= min_tokens
                and eng._inflight is not None):
            return req
    raise AssertionError("never reached an in-flight state")


def _pair(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (20,)).tolist(),
            rng.integers(0, cfg.vocab, (24,)).tolist())


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_overlap_cancel_races_inflight_tick(setup, spec):
    """A cancel between ticks, while the victim's next window is in
    flight: the window is dropped at the commit, the victim's stream ends
    at what it had committed, the release runs at once (and only once) and
    the co-tenant equals the serial run; nothing is captured again."""
    _, cfg, _, params = setup
    pa, pb = _pair(cfg)
    sp = SamplingParams(max_new_tokens=8)
    kw = dict(spec=SpecConfig(k=3) if spec else None)
    serial = _engine(params, cfg, **kw)
    ra, rv = serial.submit(pa, sp), serial.submit(pb, sp)
    out = serial.run()
    solo_a, solo_v = list(out[ra].token_ids), list(out[rv].token_ids)

    eng = _engine(params, cfg, overlap=True, **kw)
    warm = eng.trace_counts()
    ra, rv = eng.submit(pa, sp), eng.submit(pb, sp)
    victim = _step_until_inflight(eng, rv)
    committed = len(victim.generated)
    releases = eng.replay_counts()["release"]
    assert eng.cancel(rv) is True
    assert eng.replay_counts()["release"] == releases + 1   # flushed now
    assert not eng._pending_release and eng._inflight is not None
    out = eng.run()
    assert out[rv].finish_reason == "cancelled"
    assert list(out[rv].token_ids) == solo_v[:committed]
    assert list(out[ra].token_ids) == solo_a
    assert eng.fault_counters == {**eng.fault_counters, "cancelled": 1,
                                  "double_release": 0}
    assert eng.trace_counts() == warm
    _assert_drained(eng)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_overlap_deadline_races_inflight_tick(setup, spec):
    """A deadline that passes while a window is in flight: the expiry at
    the next tick's start commits at most that window, never the tokens
    dispatched past it; the co-tenant equals the serial run."""
    _, cfg, _, params = setup
    pa, pb = _pair(cfg)
    kw = dict(spec=SpecConfig(k=3) if spec else None)
    serial = _engine(params, cfg, **kw)
    ra = serial.submit(pa, SamplingParams(max_new_tokens=8))
    rb = serial.submit(pb, SamplingParams(max_new_tokens=8))
    out = serial.run()
    solo_a, solo_b = list(out[ra].token_ids), list(out[rb].token_ids)

    clk = FakeClock()
    eng = _engine(params, cfg, overlap=True, clock=clk, **kw)
    ra = eng.submit(pa, SamplingParams(max_new_tokens=8))
    rb = eng.submit(pb, SamplingParams(max_new_tokens=8, deadline_s=5.0))
    victim = _step_until_inflight(eng, rb)
    committed = len(victim.generated)
    clk.t += 10.0                                # expire rb mid-pipeline
    out = eng.run()
    assert out[rb].finish_reason == "timeout"
    window = 4 if spec else 1
    assert committed <= len(out[rb].token_ids) <= committed + window
    assert list(out[rb].token_ids) == solo_b[:len(out[rb].token_ids)]
    assert list(out[ra].token_ids) == solo_a
    assert eng.fault_counters["timeout"] == 1
    _assert_drained(eng)


def test_shed_single_counter_path_and_queue_gauge(setup):
    """``Scheduler.shed_count`` is the one counter: the engine's mirror and
    the obs lifecycle counter re-sync from it, and the submit path keeps
    the queue-depth gauge current."""
    _, cfg, _, params = setup
    obs = Observability()
    eng = _engine(params, cfg, overlap=True, max_queue=2, obs=obs)
    prompts = _prompts(cfg.vocab)
    sp = SamplingParams(max_new_tokens=4)
    snaps = []
    eng.submit(prompts[0], sp)
    eng.submit(prompts[1], sp)
    assert obs.snapshot()["repro_queue_depth"] == 2.0
    eng.submit(prompts[2], sp, on_token=snaps.append)   # bound hit: shed
    assert [s.finish_reason for s in snaps] == ["shed"]
    assert eng.scheduler.shed_count == 1
    assert eng.fault_counters["shed"] == eng.scheduler.shed_count
    eng.run()
    assert obs.snapshot()["repro_queue_depth"] == 0.0
    assert obs.snapshot()[
        'repro_lifecycle_events_total{event="shed"}'] == 1.0
    for p in prompts[:2]:
        eng.submit(p, sp)
    eng.submit(prompts[3], sp)                   # bound hit again
    assert eng.scheduler.shed_count == 2
    assert eng.fault_counters["shed"] == 2
    eng.run()
    assert obs.snapshot()[
        'repro_lifecycle_events_total{event="shed"}'] == 2.0
    _assert_drained(eng)
    obs.close()
