"""The port's fault-tolerant lifecycle, mirroring ``tests/test_faults.py``
apart from its snapshot and checkify cases (``test_torch_snapshot.py``,
``test_torch_checkify.py``): the seeded
fault plan; the scheduler's shedding, backoff, deadlines and cancellation;
the release a masked no-op on a free slot; the engine's shedding,
deadlines (a committed stop beats a later deadline), cancellation with
co-tenants token-identical, the seeded fault matrix over every engine site
(paged, ``k = 3``, serial and overlapped) and the counted double release.
One case drives the reference ``ContinuousEngine`` and the port's with the
same seeded plan and the same fake clock, at f32, paged, ``k = 3``: the
same sites fire in the same order, with the same counters, finish reasons
and non-victim tokens."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import FaultPlan as JaxPlan
from repro.serving import SamplingParams as JaxParams
from repro.serving import SpecConfig as JaxSpec

from repro_torch.serving import (CachePool, ContinuousEngine, Fault,
                                 FaultError, FaultPlan, SamplingParams,
                                 Scheduler, SpecConfig, corrupt_snapshot,
                                 stable_trace_counts)
from repro_torch.serving.faults import (DOUBLE_RELEASE, DRAFTER_ERROR,
                                        ENGINE_SITES, PAGE_EXHAUSTION)

from torch_parity import configs, sparse_params


class FakeClock:
    """Injected monotonic clock: tests advance time, nothing sleeps."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


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
    jcfg, tcfg = configs("float32", kv_k_sparsity=0.3, kv_v_sparsity=0.5,
                         kv_tail=16)
    jparams, tparams = sparse_params(jcfg, tcfg)
    return jcfg, tcfg, jparams, tparams


def _engine(params, cfg, cls=ContinuousEngine, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_tokens", 96)
    kw.setdefault("bs", 16)
    kw.setdefault("prefill_chunk", 32)
    if cls is ContinuousEngine:
        kw.setdefault("device", "cpu")
    return cls(params, cfg, **kw)


# ---------------------------------------------------------------------------
# fault plan: seeded, replayable, must drain
# ---------------------------------------------------------------------------

def test_fault_plan_seeded_replay_take_and_exhaustion():
    a = FaultPlan.generate(seed=7, ticks=20)
    b = FaultPlan.generate(seed=7, ticks=20)
    assert a.pending() == b.pending()
    assert {f.site for f in a.pending()} == set(ENGINE_SITES)
    # the port's copy draws the reference's schedule from the same seed
    ref = JaxPlan.generate(seed=7, ticks=20)
    assert [(f.site, f.tick) for f in a.pending()] == \
        [(f.site, f.tick) for f in ref.pending()]
    plan = FaultPlan([Fault(DOUBLE_RELEASE, 5), Fault(DOUBLE_RELEASE, 2)])
    assert not plan.take(DOUBLE_RELEASE, 1)
    assert plan.take(DOUBLE_RELEASE, 3)          # oldest (tick 2) pops first
    assert not plan.take(PAGE_EXHAUSTION, 99)    # wrong site never matches
    assert not plan.exhausted()
    assert plan.take(DOUBLE_RELEASE, 7)
    assert plan.exhausted() and plan.fired == [(3, DOUBLE_RELEASE),
                                               (7, DOUBLE_RELEASE)]
    p1, p2 = FaultPlan(seed=3), FaultPlan(seed=3)
    picks1 = [p1.choose(list(range(10))) for _ in range(8)]
    picks2 = [p2.choose(list(range(10))) for _ in range(8)]
    assert picks1 == picks2
    ref = JaxPlan(seed=3)
    assert picks1 == [ref.choose(list(range(10))) for _ in range(8)]


def test_fault_plan_validation():
    with pytest.raises(ValueError, match="unknown fault site"):
        Fault("frobnicate", 1)
    with pytest.raises(ValueError, match="tick"):
        Fault(DOUBLE_RELEASE, -1)
    with pytest.raises(ValueError, match="at least one option"):
        FaultPlan().choose([])
    with pytest.raises(FaultError, match="injected fault"):
        FaultPlan(seed=4).raise_fault(DRAFTER_ERROR)


def test_corrupt_snapshot_modes(tmp_path):
    with pytest.raises(ValueError, match="no snapshot steps"):
        corrupt_snapshot(str(tmp_path))
    step = tmp_path / "step_0000000001"
    step.mkdir()
    path = step / "arrays.npz"
    np.savez(path, w=np.arange(256, dtype=np.float32))
    whole = path.read_bytes()
    assert corrupt_snapshot(str(tmp_path), mode="garbage", seed=1) \
        == str(path)
    garbled = path.read_bytes()
    assert len(garbled) == len(whole) and garbled != whole
    corrupt_snapshot(str(tmp_path), mode="truncate")
    assert os.path.getsize(path) == len(whole) // 2
    with pytest.raises(ValueError, match="unknown corruption mode"):
        corrupt_snapshot(str(tmp_path), mode="eat")


# ---------------------------------------------------------------------------
# scheduler: shed / backoff / deadlines (host-only, injected clock)
# ---------------------------------------------------------------------------

def test_scheduler_sheds_past_queue_bound():
    clk = FakeClock()
    sch = Scheduler(slots=1, capacity_tokens=64, bs=16, clock=clk,
                    max_queue=2)
    r1 = sch.submit([1, 2, 3])
    r2 = sch.submit([4, 5, 6])
    r3 = sch.submit([7, 8, 9])                   # queue full -> shed
    assert len(sch.queue) == 2
    shed = sch.finished[r3]
    assert shed.finish_reason == "shed" and shed.finished_time == clk.t
    assert r1 not in sch.finished and r2 not in sch.finished
    assert sch.shed_count == 1
    free = Scheduler(slots=1, capacity_tokens=64, bs=16, clock=clk)
    for _ in range(10):
        free.submit([1])
    assert not free.finished


def test_scheduler_backoff_doubles_and_preserves_fifo():
    clk = FakeClock()
    sch = Scheduler(slots=2, capacity_tokens=64, bs=16, clock=clk,
                    backoff_base=0.01, backoff_cap=0.03)
    ra = sch.submit([1, 2])
    rb = sch.submit([3, 4])
    b1 = sch.defer_admission()
    assert b1 == 0.01
    assert sch.admit() is None                   # head backing off
    b2 = sch.defer_admission()
    assert b2 == 2 * b1
    b3 = sch.defer_admission()
    assert b3 == 0.03                            # capped
    clk.t = 0.02
    assert sch.admit() is None                   # nothing admits around it
    clk.t = 0.05
    assert sch.admit().rid == ra
    assert sch.admit().rid == rb                 # rb never jumped the line


def test_scheduler_deadlines_ttft_vs_total():
    clk = FakeClock()
    sch = Scheduler(slots=2, capacity_tokens=64, bs=16, clock=clk)
    ra = sch.submit([1, 2], SamplingParams(max_new_tokens=4,
                                           ttft_deadline_s=1.0))
    rb = sch.submit([3, 4], SamplingParams(max_new_tokens=4,
                                           deadline_s=2.0))
    a, b = sch.admit(), sch.admit()
    assert (a.rid, b.rid) == (ra, rb)
    clk.t = 0.5
    sch.record_token(a.slot, 11)
    clk.t = 1.5
    assert sch.expire() == []                    # ra produced in time
    sch.record_token(b.slot, 22)
    clk.t = 2.5
    expired = sch.expire()
    assert [r.rid for r in expired] == [rb]
    assert expired[0].finish_reason == "timeout" and expired[0].slot >= 0
    rq = sch.submit([5], SamplingParams(max_new_tokens=1,
                                        ttft_deadline_s=0.1))
    clk.t = 3.0
    (gone,) = sch.expire()
    assert gone.rid == rq and gone.slot == -1
    assert gone.finish_reason == "timeout"


def test_scheduler_cancel_everywhere_and_validation():
    sch = Scheduler(slots=1, capacity_tokens=64, bs=16, clock=FakeClock())
    ra = sch.submit([1, 2])
    rb = sch.submit([3, 4])
    sch.admit()
    queued = sch.cancel(rb)
    assert queued.finish_reason == "cancelled" and queued.slot == -1
    active = sch.cancel(ra)
    assert active.finish_reason == "cancelled" and active.slot == 0
    assert not sch.active
    assert sch.cancel(ra) is None                # already finished: no-op
    assert sch.cancel(999) is None               # unknown rid: no-op


# ---------------------------------------------------------------------------
# pool: release is a masked no-op on an already-free slot
# ---------------------------------------------------------------------------

def test_release_idempotent(setup):
    """Releasing a slot twice decrements nothing the second time: the live
    mask is gated on ``prefix_blocks``, which the first release zeroed —
    the device half of the double-release fault site."""
    _, cfg, _, _ = setup
    pool = CachePool.build(cfg, slots=3, max_tokens=64, bs=16, paged=True,
                           device="cpu")
    state = pool.init_state()
    state["tail_len"][0] = 16
    state["pos"][0] = 16
    ids = torch.zeros((pool.slots, pool.tail // pool.bs), dtype=torch.long)
    pool.refreeze(state, ids, torch.ones(1, dtype=torch.bool))
    assert int(state["refcount"].sum()) == 1
    rel = torch.tensor([0, -1, -1], dtype=torch.int32)
    pool.release(state, rel)
    assert int(state["refcount"].sum()) == 0
    pool.release(state, rel)                     # masked no-op
    assert int(state["refcount"].sum()) == 0
    assert state["prefix_blocks"].tolist() == [0, 0, 0]


# ---------------------------------------------------------------------------
# engine: shed / deadlines / cancellation (injected clock, flat pool)
# ---------------------------------------------------------------------------

def test_engine_shed_deadline_and_eos_precedence(setup):
    _, cfg, _, params = setup
    clk = FakeClock()
    eng = _engine(params, cfg, max_queue=2, clock=clk)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (20,)).tolist() for _ in range(4)]

    snaps = []
    r1 = eng.submit(prompts[0], SamplingParams(max_new_tokens=6))
    r2 = eng.submit(prompts[1], SamplingParams(max_new_tokens=6))
    r3 = eng.submit(prompts[2], SamplingParams(max_new_tokens=6),
                    on_token=snaps.append)
    assert [s.finish_reason for s in snaps] == ["shed"]
    assert eng.fault_counters["shed"] == 1 and r3 not in eng._callbacks
    out = eng.run()
    assert out[r1].finish_reason == "length" and len(out[r1].token_ids) == 6
    assert out[r2].finish_reason == "length"
    baseline = list(out[r1].token_ids)

    # a deadline mid-stream: partial output survives, the co-tenant is
    # token-identical to the clean run
    ra = eng.submit(prompts[0], SamplingParams(max_new_tokens=6))
    rb = eng.submit(prompts[3], SamplingParams(max_new_tokens=6,
                                               deadline_s=5.0))
    while not eng.scheduler.done():
        eng.step()
        if any(r.rid == rb and len(r.generated) >= 2
               for r in eng.scheduler.active.values()):
            clk.t += 10.0                        # blow rb's deadline
    res = {rid: req.output() for rid, req in eng.scheduler.finished.items()}
    assert res[rb].finish_reason == "timeout"
    assert 2 <= len(res[rb].token_ids) < 6
    assert res[ra].finish_reason == "length"
    assert list(res[ra].token_ids) == baseline
    assert eng.fault_counters["timeout"] == 1
    assert not eng._blocks and not eng.scheduler.active

    # precedence: the deadline passes after the last token committed
    rc = eng.submit(prompts[1], SamplingParams(max_new_tokens=3,
                                               deadline_s=50.0))
    while not eng.scheduler.done():
        eng.step()
    clk.t += 100.0
    eng.step()
    outc = eng.scheduler.finished[rc].output()
    assert outc.finish_reason == "length" and len(outc.token_ids) == 3
    assert eng.fault_counters["timeout"] == 1

    # a ttft deadline on a request that never got a slot in time
    eng.submit(prompts[0], SamplingParams(max_new_tokens=6))
    eng.submit(prompts[1], SamplingParams(max_new_tokens=6))
    eng.step()
    rq = eng.submit(prompts[2], SamplingParams(max_new_tokens=6,
                                               ttft_deadline_s=1.0))
    eng.step()
    clk.t += 2.0
    eng.run()
    assert eng.scheduler.finished[rq].output().finish_reason == "timeout"
    assert not eng._slot_live.any()


def test_cancellation_token_identity(setup):
    """Cancelling one request leaves the co-tenants' tokens identical to a
    run where the victim never existed, recycles the slot and captures
    nothing more."""
    _, cfg, _, params = setup
    eng = _engine(params, cfg)
    rng = np.random.default_rng(1)
    pa = rng.integers(0, cfg.vocab, (20,)).tolist()
    pb = rng.integers(0, cfg.vocab, (24,)).tolist()
    sp = SamplingParams(max_new_tokens=8)

    ra = eng.submit(pa, sp)
    solo = list(eng.run()[ra].token_ids)
    warm = eng.trace_counts()

    ra = eng.submit(pa, sp)
    snaps = []
    rv = eng.submit(pb, sp, on_token=snaps.append)
    while not any(s.request_id == rv and len(s.token_ids) >= 2
                  for s in snaps):
        eng.step()
    assert eng.cancel(rv) is True
    assert eng.cancel(rv) is False               # second cancel: quiet no-op
    assert snaps[-1].finish_reason == "cancelled"
    out = eng.run()
    assert list(out[ra].token_ids) == solo
    assert out[rv].finish_reason == "cancelled"
    assert eng.fault_counters["cancelled"] == 1

    ra = eng.submit(pa, sp)
    eng.submit(pb, sp)
    rq = eng.submit(pa, sp)                      # 3rd request, 2 slots
    assert eng.cancel(rq) is True
    out = eng.run()
    assert list(out[ra].token_ids) == solo
    assert out[rq].finish_reason == "cancelled"
    assert len(out[rq].token_ids) == 0
    assert eng.trace_counts() == warm
    assert not eng.scheduler.active and not eng._slot_live.any()


# ---------------------------------------------------------------------------
# engine: the seeded fault matrix (paged + speculative)
# ---------------------------------------------------------------------------

def _fault_wave(cfg, seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab, (32,)).tolist()
    return [shared + rng.integers(0, cfg.vocab, (4,)).tolist(),
            shared + rng.integers(0, cfg.vocab, (7,)).tolist(),
            rng.integers(0, cfg.vocab, (40,)).tolist(),
            rng.integers(0, cfg.vocab, (12,)).tolist()]


def _drive_matrix(eng, prompts, plan=None, clock=None, sp=None,
                  max_ticks=400):
    """Keep the engine under traffic until the plan drains (or one wave
    finishes, fault-free); returns {(wave, prompt index): Request}.  A
    fake ``clock`` advances 4 ms a tick, so backoffs expire."""
    sp = sp or SamplingParams(max_new_tokens=10)
    done, wave = {}, 0
    rids = {eng.submit(p, sp): (wave, i) for i, p in enumerate(prompts)}
    for _ in range(max_ticks):
        if clock is not None:
            clock.t += 0.004
        eng.step()
        if eng.scheduler.done():
            for rid, key in rids.items():
                done[key] = eng.scheduler.finished[rid]
            if plan is None or plan.exhausted():
                break
            wave += 1
            rids = {eng.submit(p, sp): (wave, i)
                    for i, p in enumerate(prompts)}
    assert eng.scheduler.done(), "matrix run did not drain"
    eng.quiesce()
    return done


def _assert_conserved(eng):
    assert not eng._blocks and not eng._reserved
    assert not eng._slot_live.any() and not eng._pending_release
    assert int(eng._alloc._ref.sum()) == 0
    assert int(eng.state["refcount"].sum()) == 0


@pytest.mark.parametrize("seed,overlap",
                         [(0, False), (1, False), (0, True), (1, True)],
                         ids=["s0", "s1", "s0-overlap", "s1-overlap"])
def test_fault_matrix_engine_survives(setup, seed, overlap):
    """Every engine fault site fires (seeded schedule); the engine ends
    drained with every refcount back to zero, holds one capture per entry,
    and every request the plan did not cancel is token-identical to the
    fault-free serial run."""
    _, cfg, _, params = setup
    prompts = _fault_wave(cfg)
    kw = dict(paged=True, spec=SpecConfig(k=3))
    clk = FakeClock()
    base = _drive_matrix(_engine(params, cfg, clock=clk, **kw), prompts,
                         clock=clk)
    base_toks = {i: list(req.output().token_ids)
                 for (_, i), req in base.items()}

    plan = FaultPlan.generate(seed=seed, ticks=16)
    clk = FakeClock()
    eng = _engine(params, cfg, faults=plan, max_queue=8, overlap=overlap,
                  clock=clk, **kw)
    done = _drive_matrix(eng, prompts, plan=plan, clock=clk)
    assert plan.exhausted(), f"plan stuck: {plan.pending()}"
    assert len(plan.fired) == len(ENGINE_SITES)

    fc = eng.fault_counters
    assert fc["cancelled"] >= 2                  # prefill + spec cancels
    assert fc["drafter_error"] == 1
    assert fc["injected_page_exhaustion"] == 1 and fc["deferred"] >= 1
    assert fc["double_release"] == 1

    traces = stable_trace_counts(eng.trace_counts())
    assert all(v == 1 for k, v in traces.items() if k != "decode"), traces
    assert eng.replay_counts()["release"] >= 2

    reasons = {req.finish_reason for req in done.values()}
    assert reasons <= {"length", "stop", "cancelled"}
    victims = 0
    for (_, i), req in done.items():
        if req.finish_reason == "cancelled":
            victims += 1
            continue
        assert list(req.output().token_ids) == base_toks[i], \
            f"prompt {i} perturbed by faults (seed {seed})"
    assert victims == fc["cancelled"]
    _assert_conserved(eng)


def test_degraded_mode_drafts_nothing_in_the_same_graph(setup):
    """Under queue pressure (``degrade_queue``) every verify tick drafts
    nothing, through the same ``[slots, k+1]`` verify graph: tokens equal
    the undegraded engine's, the degraded ticks are counted and the
    verify entry keeps its one capture."""
    _, cfg, _, params = setup
    prompts = _fault_wave(cfg, seed=2) * 2
    sp = SamplingParams(max_new_tokens=8)
    want = _engine(params, cfg, spec=SpecConfig(k=3))
    rids = [want.submit(p, sp) for p in prompts]
    out = want.run()
    eng = _engine(params, cfg, spec=SpecConfig(k=3), degrade_queue=2)
    drafted = []
    propose = eng.drafter.propose
    eng.drafter.propose = lambda *a: drafted.append(len(eng.scheduler.queue)) \
        or propose(*a)
    got_rids = [eng.submit(p, sp) for p in prompts]
    got = eng.run()
    assert [list(got[r].token_ids) for r in got_rids] == \
        [list(out[r].token_ids) for r in rids]
    assert eng.fault_counters["degraded_ticks"] >= 3
    assert all(q < 2 for q in drafted)           # never under pressure
    assert eng.trace_counts()["verify"] == 1
    assert eng.replay_counts()["verify"] > \
        eng.fault_counters["degraded_ticks"]


def test_double_release_is_counted_not_fatal(setup):
    """An already-free slot pushed through the release path is absorbed as
    a counted warning (allocator untouched, device no-op) and the engine
    keeps serving."""
    _, cfg, _, params = setup
    plan = FaultPlan([Fault(DOUBLE_RELEASE, 1)], seed=0)
    eng = _engine(params, cfg, paged=True, faults=plan)
    rids = [eng.submit(p, SamplingParams(max_new_tokens=6))
            for p in _fault_wave(cfg)[:2]]
    while not eng.scheduler.done():
        eng.step()
    assert plan.exhausted()
    assert eng.fault_counters["double_release"] >= 1
    for r in rids:
        assert eng.scheduler.finished[r].output().finish_reason == "length"
    _assert_conserved(eng)


# ---------------------------------------------------------------------------
# the same faulted run through the reference engine and the port's
# ---------------------------------------------------------------------------

def test_faulted_run_matches_the_reference_engine(setup):
    """``FaultPlan.generate(seed=0)`` and a fake clock drive the reference
    ``ContinuousEngine`` and the port's (f32, paged, ``k = 3``, serial):
    the sites fire at the same ticks in the same order, and the counters,
    every request's finish reason and every non-victim's tokens agree."""
    jcfg, tcfg, jparams, tparams = setup
    prompts = _fault_wave(tcfg)
    runs = []
    for params, cfg, cls, plan_cls, sp, spec, as_prompt in (
            (jparams, jcfg, JaxEngine, JaxPlan, JaxParams, JaxSpec,
             lambda p: jnp.asarray(p, jnp.int32)),
            (tparams, tcfg, ContinuousEngine, FaultPlan, SamplingParams,
             SpecConfig, list)):
        plan = plan_cls.generate(seed=0, ticks=16)
        clk = FakeClock()
        eng = _engine(params, cfg, cls, paged=True, spec=spec(k=3),
                      faults=plan, max_queue=8, clock=clk)
        done = _drive_matrix(eng, [as_prompt(p) for p in prompts],
                             plan=plan, clock=clk,
                             sp=sp(max_new_tokens=10))
        assert plan.exhausted()
        runs.append({"fired": list(plan.fired),
                     "counters": dict(eng.fault_counters),
                     "reasons": {k: r.finish_reason
                                 for k, r in done.items()},
                     "tokens": {k: list(r.output().token_ids)
                                for k, r in done.items()
                                if r.finish_reason != "cancelled"}})
    ref, got = runs
    assert got["fired"] == ref["fired"]
    assert [site for _, site in got["fired"]] and \
        {site for _, site in got["fired"]} == set(ENGINE_SITES)
    assert got["counters"] == ref["counters"]
    assert got["reasons"] == ref["reasons"]
    assert got["tokens"] == ref["tokens"]
