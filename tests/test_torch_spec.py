"""Speculative decoding in the port, held against the reference
(``tests/test_spec_decode.py`` and the paged case of
``tests/test_paged_pool.py``):

* ``accept_step``: greedy lanes accept by exact match, masked slots commit
  nothing and draw nothing, rejection sampling leaves the output
  distribution unchanged (chi-square test), a certain draft is always
  accepted;
* ``CachePool.rollback`` is the exact inverse of ``append_many``, clamps at
  the frozen-prefix boundary and composes with refreeze, on the flat and
  the paged pool, state for state with the reference pool;
* ``Scheduler.record_tokens`` commits windows with the stop scan inside;
* the copied ``NGramDrafter`` / ``AdaptiveDraft`` behave as the reference's;
* greedy spec-on engines emit the spec-off engine's tokens and the
  reference spec engine's (f32, flat and paged), with the same accepted-
  and proposed-draft histograms;
* the engine and the serve CLI take any ``k >= 0``, as the reference does:
  at k = 32 the verify panel holds (k+1)*G = 66 rows of head dim 32, past
  the 2048 values the first attention kernel kept in registers, and the
  greedy tokens still equal the reference's, flat and paged.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.serving import AdaptiveDraft as JaxAdaptive
from repro.serving import CachePool as JaxPool
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import NGramDrafter as JaxDrafter
from repro.serving import SamplingParams as JaxParams
from repro.serving import Scheduler as JaxScheduler
from repro.serving import SpecConfig as JaxSpec
from repro.serving import sampling as jsampling

from repro_torch.configs import get_config as torch_config
from repro_torch.launch import serve
from repro_torch.serving import (AdaptiveDraft, ContinuousEngine,
                                 NGramDrafter, SamplingParams, SpecConfig)
from repro_torch.serving import sampling as tsampling
from repro_torch.kernels import ops as tops
from repro_torch.serving.cache_pool import CachePool
from repro_torch.serving.scheduler import Scheduler

from torch_parity import configs, sparse_params


# ---------------------------------------------------------------------------
# accept_step
# ---------------------------------------------------------------------------

def _lanes(temps):
    b = len(temps)
    lanes = tsampling.init_lanes(b, "cpu")
    lanes["temperature"] = torch.tensor(temps, dtype=torch.float32)
    return lanes


def _jax_lanes(temps, seed=0):
    lanes = jsampling.init_lanes(len(temps))
    lanes["temperature"] = jnp.asarray(temps, jnp.float32)
    lanes["rng"] = jnp.stack([jax.random.PRNGKey(seed + i)
                              for i in range(len(temps))])
    return lanes


def _gens(temps, seed=0):
    return [tsampling.request_generator(SamplingParams(seed=seed + i), "cpu")
            if t > 0 else None for i, t in enumerate(temps)]


def test_accept_step_greedy_exact_match():
    """Greedy lanes accept drafts exactly while they match argmax and
    commit the correction after the first miss, as the reference does."""
    v, qn = 11, 4
    logits = np.full((3, qn, v), -10.0, np.float32)
    for j in range(qn):
        logits[:, j, j + 1] = 10.0
    logits += np.random.default_rng(0).normal(size=logits.shape).astype(
        np.float32) * 0.1
    panel = np.zeros((3, qn), np.int64)
    panel[0] = [0, 1, 2, 99 % v]   # 2 good drafts, third wrong
    panel[1] = [0, 1, 2, 3]        # all 3 drafts right
    panel[2] = [0, 9, 9, 9]        # draft lanes invalid (draft_len 0)
    dlen = np.asarray([3, 3, 0])
    temps = [0.0, 0.0, 0.0]
    tok, logp, nc = tsampling.accept_step(
        torch.from_numpy(logits), torch.from_numpy(panel),
        torch.from_numpy(dlen), _lanes(temps), _gens(temps), [True] * 3)
    assert nc.tolist() == [3, 4, 1]
    assert tok[0, :3].tolist() == [1, 2, 3]
    assert tok[1].tolist() == [1, 2, 3, 4]
    assert tok[2, 0] == 1
    jtok, jlogp, jnc, _ = jsampling.accept_step(
        jnp.asarray(logits), jnp.asarray(panel, jnp.int32),
        jnp.asarray(dlen, jnp.int32), _jax_lanes(temps),
        jnp.ones((3,), bool))
    assert nc.tolist() == np.asarray(jnc).tolist()
    for b, n in enumerate(nc.tolist()):
        assert tok[b, :n].tolist() == np.asarray(jtok)[b, :n].tolist()
        np.testing.assert_allclose(logp[b, :n].numpy(),
                                   np.asarray(jlogp)[b, :n], rtol=1e-6)


def test_accept_step_masked_slot_commits_and_draws_nothing():
    logits = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 3, 7)).astype(np.float32))
    temps = [0.0, 0.7]
    gens = _gens(temps)
    state = gens[1].get_state()
    _, _, nc = tsampling.accept_step(
        logits, torch.zeros((2, 3), dtype=torch.long),
        torch.tensor([2, 2]), _lanes(temps), gens, [True, False])
    assert nc.tolist()[1] == 0 and nc.tolist()[0] >= 1
    assert torch.equal(gens[1].get_state(), state)   # no draw consumed


# the 0.999 quantile of the chi-square distribution at 2 degrees of freedom
CHI2_999_DF2 = 13.82


@pytest.mark.parametrize("draft", [3, 0, 1],
                         ids=["p0_always_rejected", "p05", "p03"])
def test_accept_step_rejection_preserves_distribution(draft):
    """Sampled lanes with a point-mass drafter: the committed first token
    follows the lane's distribution p, whatever the draft (accepted with
    probability p(draft), else drawn from the residual that excludes it).
    n independent lanes, each on its own seeded generator; Pearson's
    statistic over the three tokens with p > 0 stays below the 0.999
    quantile at 2 degrees of freedom (a false alarm once in a thousand
    seeds; the seeds are fixed)."""
    v, n = 4, 3000
    probs = np.asarray([0.5, 0.3, 0.2, 0.0], np.float32)
    logits = torch.from_numpy(np.log(np.maximum(probs, 1e-9))).expand(
        n, 2, v).contiguous()
    panel = torch.tensor([0, draft]).expand(n, 2).contiguous()
    temps = [1.0] * n
    tok, _, nc = tsampling.accept_step(
        logits, panel, torch.ones(n, dtype=torch.long), _lanes(temps),
        _gens(temps, seed=100 * draft), [True] * n)
    first = tok[:, 0].numpy()
    counts = np.bincount(first, minlength=v)
    assert counts[3] == 0                     # p = 0 is never emitted
    expect = probs[:3] * n
    chi2 = float(((counts[:3] - expect) ** 2 / expect).sum())
    assert chi2 < CHI2_999_DF2, (counts, chi2)
    if draft == 3:
        assert nc.tolist() == [1] * n         # always rejected
    else:                                     # accepted with p(draft)
        acc = (nc == 2).float().mean().item()
        assert abs(acc - probs[draft]) < 4 * np.sqrt(
            probs[draft] * (1 - probs[draft]) / n)


def test_accept_step_certain_draft_always_accepted():
    v, qn = 5, 3
    logits = np.full((1, qn, v), -30.0, np.float32)
    logits[:, :, 2] = 30.0
    tok, _, nc = tsampling.accept_step(
        torch.from_numpy(logits), torch.tensor([[2, 2, 2]]),
        torch.tensor([2]), _lanes([0.9]), _gens([0.9]), [True])
    assert nc.tolist() == [3]
    assert tok[0].tolist() == [2, 2, 2]


# ---------------------------------------------------------------------------
# CachePool: append_many / rollback / refreeze, flat and paged
# ---------------------------------------------------------------------------

def _pools(paged, slots=2, kv_tail=16, bs=16):
    kw = dict(kv_k_sparsity=0.0, kv_v_sparsity=0.0, kv_tail=kv_tail,
              compute_dtype="float32", param_dtype="float32")
    jcfg = dataclasses.replace(jax_config("qwen3-0.6b").reduced(), **kw)
    tcfg = dataclasses.replace(torch_config("qwen3-0.6b").reduced(), **kw)
    return (tcfg,
            JaxPool.build(jcfg, slots=slots, max_tokens=64, bs=bs,
                          paged=paged),
            CachePool.build(tcfg, slots=slots, max_tokens=64, bs=bs,
                            paged=paged, device="cpu"))


def _panels(pool, cfg, m, seed=0):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, pool.slots, cfg.n_kv, m, cfg.hd)
    return {"l0": {"k": rng.normal(size=shape).astype(np.float32),
                   "v": rng.normal(size=shape).astype(np.float32)}}


def _tp(panels):
    return {n: {k: torch.from_numpy(a) for k, a in p.items()}
            for n, p in panels.items()}


def _jp(panels):
    return {n: {k: jnp.asarray(a) for k, a in p.items()}
            for n, p in panels.items()}


def _visible(state, tail):
    """The observable (length-gated) pool state as numpy: lengths, the
    valid tail region, the whole compressed storage (and table, refcount)."""
    a = (lambda x: x.numpy()) if isinstance(state["pos"], torch.Tensor) \
        else np.asarray
    vis = {k: a(state[k]) for k in ("pos", "prefix_blocks", "tail_len",
                                    "table", "refcount") if k in state}
    live = (np.arange(tail)[None, None, None, :, None]
            < vis["tail_len"][None, :, None, None, None])
    for name, leaf in state["layers"].items():
        for key, arr in leaf["kv"].items():
            x = a(arr)
            if x.dtype == np.uint32:
                x = x.view(np.int32)
            vis[f"{name}/{key}"] = np.where(live, x, 0) if "tail" in key \
                else x
    return vis


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _ids(pool, slots):
    """Fresh arena ids for a paged refreeze of ``slots`` (None when flat)."""
    if not pool.paged:
        return None
    tb = pool.tail // pool.bs
    ids = np.zeros((pool.slots, tb), np.int32)
    for n, s in enumerate(slots):
        ids[s] = np.arange(n * tb, (n + 1) * tb)
    return ids


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_rollback_is_exact_inverse_of_append(paged):
    cfg, jpool, pool = _pools(paged)
    st, jst = pool.init_state(), dict(jpool.init_state())
    st["tail_len"].copy_(torch.tensor([3, 7]))
    st["pos"].copy_(torch.tensor([3, 7]))
    jst["tail_len"] = jnp.asarray([3, 7], jnp.int32)
    jst["pos"] = jnp.asarray([3, 7], jnp.int32)
    before = _visible(st, pool.tail)
    panels = _panels(pool, cfg, 4, seed=1)
    n = np.asarray([4, 2], np.int32)
    pool.append_many(st, _tp(panels), torch.from_numpy(n))
    jst = jpool.append_many(jst, _jp(panels), jnp.asarray(n))
    assert st["tail_len"].tolist() == [7, 9] and st["pos"].tolist() == [7, 9]
    _same(_visible(st, pool.tail), _visible(jst, pool.tail))
    pool.rollback(st, torch.from_numpy(n))
    _same(_visible(st, pool.tail), before)


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_rollback_clamps_at_frozen_prefix_boundary(paged):
    """Rolling back more than the tail holds stops at the boundary: the
    frozen prefix (and the pos it accounts for) is untouchable."""
    _, jpool, pool = _pools(paged)
    st = pool.init_state()
    st["prefix_blocks"].copy_(torch.tensor([1, 0]))
    st["tail_len"].copy_(torch.tensor([2, 5]))
    st["pos"].copy_(torch.tensor([18, 5]))
    jst = {**jpool.init_state(),
           "prefix_blocks": jnp.asarray([1, 0], jnp.int32),
           "tail_len": jnp.asarray([2, 5], jnp.int32),
           "pos": jnp.asarray([18, 5], jnp.int32)}
    pool.rollback(st, torch.tensor([100, 3]))
    jst = jpool.rollback(jst, jnp.asarray([100, 3], jnp.int32))
    assert st["tail_len"].tolist() == [0, 2]
    assert st["pos"].tolist() == [16, 2]
    assert st["prefix_blocks"].tolist() == [1, 0]
    _same(_visible(st, pool.tail), _visible(jst, pool.tail))


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_refreeze_after_partial_rollback_roundtrips(paged):
    """Fill the tail, roll 5 back, re-append 5 other tokens, refreeze: the
    result equals freezing the surviving tokens appended directly, and the
    reference pool's result on the same path."""
    cfg, jpool, pool = _pools(paged)
    t = pool.tail
    panels = _panels(pool, cfg, t, seed=2)
    repl = _panels(pool, cfg, t, seed=3)
    tail5 = {n: {k: a[:, :, :, :5] for k, a in p.items()}
             for n, p in repl.items()}
    ids = _ids(pool, [0, 1])

    def refreeze(st):
        return pool.refreeze(st, ids) if paged else pool.refreeze(st)

    st = pool.append_many(pool.init_state(), _tp(panels), t)
    pool.rollback(st, 5)
    pool.append_many(st, _tp(tail5), 5)
    out_a = refreeze(st)

    direct = {n: {k: np.concatenate([panels[n][k][:, :, :, :t - 5],
                                     repl[n][k][:, :, :, :5]], axis=3)
                  for k in ("k", "v")} for n in panels}
    out_b = refreeze(pool.append_many(pool.init_state(), _tp(direct), t))
    _same(_visible(out_a, t), _visible(out_b, t))
    assert out_a["tail_len"].tolist() == [0, 0]
    assert out_a["prefix_blocks"].tolist() == [1, 1]

    jst = jpool.append_many(jpool.init_state(), _jp(panels), t)
    jst = jpool.rollback(jst, 5)
    jst = jpool.append_many(jst, _jp(tail5), 5)
    jst = (jpool.refreeze(jst, jnp.asarray(ids)) if paged
           else jpool.refreeze(jst))
    _same(_visible(out_a, t), _visible(jst, t))


# ---------------------------------------------------------------------------
# scheduler windows
# ---------------------------------------------------------------------------

def _windows(scheduler_cls, params_cls):
    """The three window cases of the reference's tests on one scheduler
    class; returns what an observer sees."""
    log = []
    sch = scheduler_cls(slots=1, capacity_tokens=128, bs=16)
    rid = sch.submit([1, 2], params_cls(max_new_tokens=32, eos_id=42))
    req = sch.admit()
    log.append(sch.record_tokens(req.slot, [7, 8], [-0.1, -0.2]))
    log.append(sch.record_tokens(req.slot, [9, 42, 77, 78]))   # eos inside
    log.append((sch.finished[rid].generated, sch.finished[rid].logprobs))
    rid = sch.submit([1], params_cls(max_new_tokens=32, stop_ids=((5, 6),)))
    req = sch.admit()
    log.append(sch.record_tokens(req.slot, [4, 5]))
    log.append(sch.record_tokens(req.slot, [6, 9]))   # across the boundary
    log.append(sch.finished[rid].generated)
    rid = sch.submit([1], params_cls(max_new_tokens=4))
    req = sch.admit()
    sch.record_tokens(req.slot, [10], decode_tick=False)
    log.append(sch.record_tokens(req.slot, [11, 12, 13, 99]))  # budget
    out = sch.finished[rid].output()
    log.append((out.token_ids, out.metrics.decode_ticks,
                out.metrics.num_generated, out.metrics.accepted_per_tick))
    return log


def test_record_tokens_windows_match_reference():
    got = _windows(Scheduler, SamplingParams)
    assert got == _windows(JaxScheduler, JaxParams)
    assert got[1] == "stop" and got[2][0] == [7, 8, 9, 42]
    assert got[2][1] == [-0.1, -0.2, None, None]
    assert got[4] == "stop" and got[5] == [4, 5, 6]
    assert got[6] == "length" and got[7] == ((10, 11, 12, 13), 1, 4, 3.0)


# ---------------------------------------------------------------------------
# drafter and adaptive controller
# ---------------------------------------------------------------------------

def test_ngram_drafter_matches_reference():
    d = NGramDrafter(max_ngram=3, min_ngram=1)
    assert d.propose([1, 2, 3, 9, 2, 3, 4, 2, 3], 3) == [4, 2, 3]
    assert d.propose([1, 2, 3], 4) == []
    assert d.propose([], 4) == []
    assert d.propose([7, 7], 2) == [7]
    assert d.propose([1, 2], 0) == []
    rng = np.random.default_rng(0)
    for max_n, min_n in ((3, 1), (2, 2), (4, 2)):
        ours, ref = NGramDrafter(max_n, min_n), JaxDrafter(max_n, min_n)
        for _ in range(150):
            hist = rng.integers(0, 4, int(rng.integers(0, 30))).tolist()
            k = int(rng.integers(0, 6))
            assert ours.propose(hist, k) == ref.propose(hist, k)


def test_adaptive_draft_matches_reference():
    kw = dict(k=4, adaptive=True, adapt_decay=0.5, adapt_min_k=1)
    ours, ref = AdaptiveDraft(SpecConfig(**kw)), JaxAdaptive(JaxSpec(**kw))
    rng = np.random.default_rng(1)
    for _ in range(60):
        s = int(rng.integers(0, 3))
        if rng.random() < 0.1:
            ours.reset(s)
            ref.reset(s)
            continue
        prop = int(rng.integers(0, 5))
        acc = int(rng.integers(0, prop + 1))
        ours.update(s, prop, acc)
        ref.update(s, prop, acc)
        assert [ours.draft_len(i) for i in range(3)] == \
            [ref.draft_len(i) for i in range(3)]
    np.testing.assert_array_equal(ours.hist, ref.hist)


def test_spec_config_checks_and_kernel_panel_limit(capsys):
    """SpecConfig's checks, and no panel limit past them: the engine and
    the serve CLI take a window wider than the 2048-value register panel
    of the first attention kernel (k = 32 at G = 2, head dim 32)."""
    with pytest.raises(ValueError):
        SpecConfig(k=-1)
    with pytest.raises(ValueError):
        SpecConfig(k=2, adaptive=True, adapt_min_k=3)
    assert not SpecConfig(k=0).active
    jcfg, tcfg = configs("float32")
    _, tparams = sparse_params(jcfg, tcfg)
    g = tcfg.padded_heads // tcfg.n_kv
    assert (WIDE_K + 1) * g * tcfg.hd > 2048
    eng = ContinuousEngine(tparams, tcfg, slots=1, device="cpu",
                           spec=SpecConfig(k=WIDE_K))
    assert eng.spec_hist.shape == (WIDE_K + 1,)
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--spec-adaptive"])
    assert serve.main(["--reduced", "--device", "cpu", "--spec-k",
                       str(WIDE_K), "--requests", "1", "--slots", "1",
                       "--prompt-len", "8", "--steps", "2"]) == 0
    assert "[serve] spec: accepted-draft histogram" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# engine: greedy token identity
# ---------------------------------------------------------------------------

LOOPY = [3, 4, 5] * 5
WIDE_K = 32         # past k = 31, the first attention kernel's cap here


def _flat_waves(eng, params_cls, toks):
    """A lockstep pair past the 16-token ring (refreezes), then a staggered
    wave of three through two slots: a loopy prompt (draft hits) and
    unaligned random ones (slots that may never get a hit)."""
    first = eng.generate_batch(toks, params_cls(max_new_tokens=24))
    rids = [eng.submit(LOOPY, params_cls(max_new_tokens=18))]
    rids += [eng.submit(toks[i % 2][:9 + 4 * i],
                        params_cls(max_new_tokens=16 - 2 * i))
             for i in range(2)]
    res = eng.run()
    return (np.asarray(first).tolist(),
            [list(res[r].token_ids) for r in rids], res)


@pytest.fixture(scope="module")
def f32_params():
    jcfg, tcfg = configs("float32", kv_tail=16)
    jparams, tparams = sparse_params(jcfg, tcfg)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 16))
    return jcfg, tcfg, jparams, tparams, toks


@pytest.mark.parametrize("adaptive", [False, True],
                         ids=["fixed_k", "adaptive_k"])
def test_flat_spec_greedy_matches_spec_off_and_reference(f32_params,
                                                         adaptive):
    jcfg, tcfg, jparams, tparams, toks = f32_params
    kw = dict(slots=2, max_tokens=96, bs=16)
    base = _flat_waves(ContinuousEngine(tparams, tcfg, device="cpu", **kw),
                       SamplingParams, toks)
    eng = ContinuousEngine(tparams, tcfg, device="cpu",
                           spec=SpecConfig(k=3, adaptive=adaptive), **kw)
    spec = _flat_waves(eng, SamplingParams, toks)
    ref = JaxEngine(jparams, jcfg, spec=JaxSpec(k=3, adaptive=adaptive),
                    **kw)
    want = _flat_waves(ref, JaxParams, jnp.asarray(toks, jnp.int32))
    assert spec[:2] == base[:2]
    assert spec[:2] == want[:2]
    np.testing.assert_array_equal(eng.spec_hist, ref.spec_hist)
    assert eng.spec_hist[0] > 0 and eng.spec_hist[1:].sum() > 0
    if adaptive:
        np.testing.assert_array_equal(eng.adaptive_hist, ref.adaptive_hist)
        assert eng.adaptive_hist.sum() == eng.spec_hist.sum()
    else:
        assert eng.adaptive_hist is None
    apt = [o.metrics.accepted_per_tick for o in spec[2].values()]
    assert all(a is not None and a >= 1.0 for a in apt)


def _paged_prompts(vocab):
    """A wave with draft hits and misses and a 32-token shared prefix."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, vocab, (32,)).tolist()
    return [shared + [3, 4, 5] * 4,
            shared + rng.integers(0, vocab, (7,)).tolist(),
            rng.integers(0, vocab, (20,)).tolist()]


def _paged_wave(eng, params_cls, prompts):
    rids = [eng.submit(p, params_cls(max_new_tokens=20)) for p in prompts]
    res = eng.run()
    return [list(res[r].token_ids) for r in rids]


def test_paged_spec_greedy_matches_flat_and_reference(f32_params):
    """Mirrors ``test_paged_pool.py``'s paged spec case: paged + spec greedy
    equals flat spec-off greedy on a wave with draft hits and misses and a
    shared prefix, and the reference's paged spec engine."""
    jcfg, tcfg, jparams, tparams, _ = f32_params
    prompts = _paged_prompts(tcfg.vocab)
    kw = dict(slots=2, max_tokens=96, bs=16, prefill_chunk=32)
    flat = _paged_wave(ContinuousEngine(tparams, tcfg, device="cpu", **kw),
                       SamplingParams, prompts)
    eng = ContinuousEngine(tparams, tcfg, device="cpu", paged=True,
                           spec=SpecConfig(k=3), **kw)
    got = _paged_wave(eng, SamplingParams, prompts)
    ref = JaxEngine(jparams, jcfg, paged=True, spec=JaxSpec(k=3), **kw)
    assert got == flat
    assert got == _paged_wave(ref, JaxParams, prompts)
    np.testing.assert_array_equal(eng.spec_hist, ref.spec_hist)
    assert eng.spec_hist[1:].sum() > 0
    assert int(eng.state["refcount"].sum()) == 0   # every page released


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_spec_past_the_old_panel_cap_matches_reference(f32_params,
                                                       monkeypatch, paged):
    """k = 32 on a 64-token tail ring (drafts are clamped to the ring's
    headroom, so the reduced config's 16-token ring could not hold the
    window): every verify tick's attention sees (k+1)*G = 66 query rows,
    and the greedy tokens and draft histograms equal the reference spec
    engine's at the same k."""
    jcfg, tcfg, jparams, tparams, toks = f32_params
    jcfg = dataclasses.replace(jcfg, kv_tail=64)
    tcfg = dataclasses.replace(tcfg, kv_tail=64)
    g = tcfg.padded_heads // tcfg.n_kv
    entry = ("sparse_decode_attention_fused_paged" if paged
             else "sparse_decode_attention_fused")
    rows = []
    fused = getattr(tops, entry)

    def recording(q, *a, **k):
        rows.append(q.shape[2])
        return fused(q, *a, **k)
    monkeypatch.setattr(tops, entry, recording)
    kw = dict(slots=2, max_tokens=128, bs=16)
    if paged:
        prompts = _paged_prompts(tcfg.vocab)
        kw.update(prefill_chunk=32, paged=True)
        eng = ContinuousEngine(tparams, tcfg, device="cpu",
                               spec=SpecConfig(k=WIDE_K), **kw)
        got = _paged_wave(eng, SamplingParams, prompts)
        ref = JaxEngine(jparams, jcfg, spec=JaxSpec(k=WIDE_K), **kw)
        want = _paged_wave(ref, JaxParams, prompts)
    else:
        eng = ContinuousEngine(tparams, tcfg, device="cpu",
                               spec=SpecConfig(k=WIDE_K), **kw)
        got = _flat_waves(eng, SamplingParams, toks)[:2]
        ref = JaxEngine(jparams, jcfg, spec=JaxSpec(k=WIDE_K), **kw)
        want = _flat_waves(ref, JaxParams, jnp.asarray(toks, jnp.int32))[:2]
    assert got == want
    np.testing.assert_array_equal(eng.spec_hist, ref.spec_hist)
    assert max(rows) == (WIDE_K + 1) * g
    assert eng.spec_hist.sum() > 0


def test_spec_sampled_lanes_run_and_respect_budget(f32_params):
    """Sampled lanes under speculation: mixed greedy and sampled lanes,
    stop and length inside accepted windows, and a seeded sampled stream
    reproducible tick for tick."""
    _, tcfg, _, tparams, toks = f32_params
    kw = dict(slots=2, max_tokens=96, bs=16, device="cpu",
              spec=SpecConfig(k=3))
    loopy = [2, 9] * 6
    sampled = SamplingParams(temperature=0.8, top_k=8, seed=7,
                             max_new_tokens=11)
    eng = ContinuousEngine(tparams, tcfg, **kw)
    r1 = eng.submit(loopy, sampled)
    r2 = eng.submit(toks[0], SamplingParams(max_new_tokens=9,
                                            stop_ids=((3, 4),)))
    res = eng.run()
    assert len(res[r1].token_ids) == 11 or res[r1].finish_reason == "stop"
    assert res[r2].finish_reason in ("stop", "length")
    assert len(res[r2].token_ids) <= 9
    eng2 = ContinuousEngine(tparams, tcfg, **kw)
    r1b = eng2.submit(loopy, sampled)
    assert res[r1].token_ids == eng2.run()[r1b].token_ids
