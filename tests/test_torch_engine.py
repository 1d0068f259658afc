"""Port engine vs the reference ``ContinuousEngine``: identical greedy
tokens on a staggered mixed-length wave that crosses refreezes (f32 model,
default KV sparsity), the sampler's masking held exactly, and seeded draws
independent of slot placement; the sharded slice's options raise and the
lifecycle options and the sanitized pool are taken."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import SamplingParams as JaxParams
from repro.serving import sampling as jsampling

from repro_torch.distributed import ShardCtx
from repro_torch.obs import Observability
from repro_torch.serving import (CachePool, ContinuousEngine, FaultPlan,
                                 SamplingParams, SpecConfig)
from repro_torch.serving import sampling as tsampling

from torch_parity import configs, sparse_params


def _wave(make_engine, params_cls, cfg, toks):
    """Two requests (one crosses two refreezes), then a staggered wave of
    three through two slots with unaligned prompts (tail remainders)."""
    eng = make_engine()
    first = eng.generate_batch(toks, params_cls(max_new_tokens=40))
    rids = [eng.submit(toks[i % 2][:9 + 4 * i],
                       params_cls(max_new_tokens=20 - 2 * i))
            for i in range(3)]
    res = eng.run()
    return np.asarray(first).tolist(), [list(res[r].token_ids) for r in rids]


def test_greedy_tokens_identical_to_reference_across_refreeze():
    jcfg, tcfg = configs("float32", kv_tail=16)
    jparams, tparams = sparse_params(jcfg, tcfg)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 21))
    ref = _wave(lambda: JaxEngine(jparams, jcfg, slots=2, max_tokens=96,
                                  bs=16, prefill_chunk=16),
                JaxParams, jcfg, jnp.asarray(toks, jnp.int32))
    port = _wave(lambda: ContinuousEngine(tparams, tcfg, slots=2,
                                          max_tokens=96, bs=16,
                                          prefill_chunk=16, device="cpu"),
                 SamplingParams, tcfg, toks)
    assert port == ref


@pytest.mark.parametrize("option", [
    {"ctx": ShardCtx(), "mesh": object()},
    {"mesh": object(), "checkify": True},
], ids=["ctx", "mesh"])
def test_later_slice_options_raise(option):
    """The refusals that remain under a mesh, before the mesh is touched:
    ``ctx=`` together with ``mesh=`` and the sanitized pool (reference
    ``engine.py:343-352``, ``:367-369``)."""
    jcfg, tcfg = configs("float32")
    _, tparams = sparse_params(jcfg, tcfg)
    want = "ctx= or mesh=" if "ctx" in option else "unsharded-only"
    with pytest.raises(ValueError, match=want):
        ContinuousEngine(tparams, tcfg, slots=1, device="cpu", **option)


@pytest.mark.parametrize("option", [
    {"faults": FaultPlan()}, {"max_queue": 4}, {"capacity_slack": 1.5},
    {"spec": SpecConfig(k=2), "degrade_queue": 2}, {"obs": Observability()},
    {"paged": True, "checkify": True},
], ids=lambda o: next(iter(o)))
def test_lifecycle_options_are_taken(option):
    """The lifecycle and telemetry options and the sanitized pool, which
    the engine refused in earlier slices, build an engine that holds them,
    with the reference's meaning."""
    jcfg, tcfg = configs("float32")
    _, tparams = sparse_params(jcfg, tcfg)
    eng = ContinuousEngine(tparams, tcfg, slots=1, device="cpu", **option)
    if "faults" in option:
        assert eng._faults is option["faults"]
    if "max_queue" in option:
        assert eng.scheduler.max_queue == 4
    if "capacity_slack" in option:
        wide = CachePool.build(tcfg, 1, eng.pool.capacity_tokens,
                               bs=eng.pool.bs, device="cpu")
        assert eng.pool.cap_v >= wide.cap_v and eng.pool.cap_k >= wide.cap_k
    if "degrade_queue" in option:
        assert eng._degrade_queue == 2 and eng.trace_counts()["verify"] == 0
    if "obs" in option:
        assert eng._obs is option["obs"]
    if "checkify" in option:
        assert eng.pool.checkify and eng.state["err"].tolist() == [0]
    rid = eng.submit([1, 2, 3], SamplingParams(max_new_tokens=2,
                                               deadline_s=60.0))
    assert eng.run()[rid].finish_reason == "length"


LANES = [  # (temperature, top_k, top_p) per lane
    pytest.param([(0.7, 0, 1.0), (1.0, 5, 1.0), (1.3, 50, 0.9),
                  (0.5, 20, 0.8)], id="bucketed"),
    pytest.param([(0.7, 0, 0.9), (1.0, 200, 0.95), (1.2, 0, 0.5),
                  (0.9, 3, 0.5)], id="exact_sort"),
]


def _masks(lanes, seed=1):
    logits = np.random.default_rng(seed).normal(size=(4, 1000)).astype(
        np.float32) * 3
    t, k, p = (np.asarray(c) for c in zip(*lanes))
    ref = jsampling._mask_logits(jnp.asarray(logits),
                                 jnp.asarray(t, jnp.float32),
                                 jnp.asarray(k, jnp.int32),
                                 jnp.asarray(p, jnp.float32))
    got = tsampling._mask_logits(torch.from_numpy(logits),
                                 torch.tensor(t, dtype=torch.float32),
                                 torch.tensor(k, dtype=torch.int32),
                                 torch.tensor(p, dtype=torch.float32))
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("lanes", LANES)
def test_mask_logits_equal_to_reference(lanes):
    ref, got = _masks(lanes)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    np.testing.assert_allclose(got[~np.isinf(got)], ref[~np.isinf(ref)],
                               rtol=1e-6)


def test_top_p_one_is_a_no_op_in_the_exact_branch():
    """A ``top_p == 1`` lane batched with a lane that forces the full
    sort: the port keeps every token (the documented no-op); the
    reference's f32 cumsum reaches 1.0 early and drops the tail whose mass
    is below float32 resolution.  Where both keep a token, the values
    agree."""
    ref, got = _masks([(0.7, 0, 1.0), (1.0, 0, 0.9), (1.0, 5, 0.9),
                       (1.0, 1, 1.0)])
    assert not np.isinf(got[0]).any()
    kept = ~np.isinf(ref[0])
    np.testing.assert_allclose(got[0][kept], ref[0][kept], rtol=1e-6)
    np.testing.assert_array_equal(np.isinf(got[1:]), np.isinf(ref[1:]))


def test_seeded_draws_independent_of_slot_and_cotenants():
    jcfg, tcfg = configs("float32")
    _, tparams = sparse_params(jcfg, tcfg)
    prompt = np.arange(7) % tcfg.vocab
    sp = SamplingParams(temperature=1.0, seed=123, max_new_tokens=12)

    def run(slots, n_before):
        eng = ContinuousEngine(tparams, tcfg, slots=slots, max_tokens=64,
                               device="cpu")
        for i in range(n_before):     # co-tenants take the earlier slots
            eng.submit(np.arange(5 + i) % tcfg.vocab,
                       SamplingParams(temperature=0.8, seed=i,
                                      max_new_tokens=12))
        rid = eng.submit(prompt, sp)
        out = eng.run()
        return out[rid].token_ids

    alone = run(1, 0)
    assert run(3, 2) == alone           # another slot, other tenants
    assert len(set(alone)) > 1          # really sampled


def test_seeded_draw_follows_the_masked_distribution():
    """Many draws from one lane match softmax of the masked logits."""
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0, 0.0, 1.5]])
    lanes = {"temperature": torch.tensor([1.0]),
             "top_k": torch.tensor([4], dtype=torch.int32),
             "top_p": torch.tensor([1.0])}
    g = tsampling.request_generator(SamplingParams(seed=7), "cpu")
    n = 4000
    counts = np.zeros(6)
    for _ in range(n):
        tok, _ = tsampling.sample_step(logits, lanes, [g], [True])
        counts[int(tok[0])] += 1
    masked = tsampling._mask_logits(logits, lanes["temperature"],
                                    lanes["top_k"], lanes["top_p"])
    expect = torch.softmax(masked, -1)[0].numpy()
    assert counts[expect == 0].sum() == 0
    np.testing.assert_allclose(counts / n, expect, atol=0.03)


def _scheduler_transcript(scheduler_cls, params_cls):
    """One scripted lifecycle on a fake clock: chunked prefill, stop
    sequences and eos inside a window, budget, shedding, cancellation,
    deadlines and the admission backoff.  Returns what an observer sees."""
    now = [0.0]
    sch = scheduler_cls(slots=2, capacity_tokens=64, bs=4, chunk=6,
                        clock=lambda: now[0], max_queue=4)
    log = []
    sp = lambda **kw: params_cls(max_new_tokens=kw.pop("n", 5), **kw)
    rids = [sch.submit(list(range(1, 11)), sp(stop_ids=((7, 8),))),
            sch.submit([5, 6, 7], sp(eos_id=9)),
            sch.submit([1, 2], sp(n=3, deadline_s=2.0)),
            sch.submit([3] * 5, sp(ttft_deadline_s=0.5)),
            sch.submit([4] * 6, sp())]              # queue full: shed
    log.append(("shed", sch.shed_count, sch.finished[rids[4]].finish_reason))
    log.append(("backoff", sch.defer_admission(), sch.admit()))
    now[0] = 1.0
    while sch.queue and sch.free_slots():
        log.append(("admit", sch.admit().rid))
    while (req := sch.next_prefill()) is not None:
        log.append(("chunk", req.rid, sch.prefill_chunk(req)))
    log.append(("decoding", sorted(sch.decoding_slots())))
    log.append(("window", sch.record_tokens(0, [3, 7, 8, 1], [0.1] * 4)))
    log.append(("eos", sch.record_tokens(1, [9], [0.2], decode_tick=False)))
    now[0] = 1.6                   # the queued TTFT deadline has passed
    log.append(("expire", [r.rid for r in sch.expire()]))
    log.append(("admit", sch.admit().rid))
    log.append(("cancel", getattr(sch.cancel(rids[2]), "rid", None),
                getattr(sch.cancel(99), "rid", None)))
    late = sch.submit([8, 8], sp(deadline_s=0.3))
    req = sch.admit()
    sch.prefill_chunk(req)
    log.append(("token", sch.record_token(req.slot, 4, 0.0)))
    now[0] = 2.0                   # the active request's deadline passed
    log.append(("expire", [r.rid for r in sch.expire()], late))
    for rid in sorted(sch.finished):
        out = sch.finished[rid].output()
        m = out.metrics
        log.append((rid, out.token_ids, out.finish_reason, out.logprobs,
                    m.ttft, m.queue_time, m.decode_ticks, m.tpot))
    log.append(("done", sch.done()))
    return log


def test_scheduler_copy_matches_reference():
    from repro.serving.scheduler import Scheduler as JaxScheduler
    from repro_torch.serving.scheduler import Scheduler as TorchScheduler
    assert _scheduler_transcript(TorchScheduler, SamplingParams) == \
        _scheduler_transcript(JaxScheduler, JaxParams)
