"""The captured forwards (``serving/engine.py::panel_entry``) on the CPU,
where a replay calls the forward on the static inputs and writes into the
same static output: logits bit-equal to the eager forward on a copy of the
same state, at the decode panel and a verify panel, flat and paged; the
engine's tokens and logprobs identical with ``graphs=True`` and
``graphs=False``; the capture (an all-false mask) leaves the state as it
was; replays count the kernel launches the graph holds and the capture
counts none; a replay after a state tensor was replaced raises; and the
kernels' per-device buffers refuse to grow while a CUDA graph is being
captured.  The ``release`` and ``set_lane`` entries leave the state the
eager transitions leave, write nothing when captured, and keep one capture
each across admissions, cancellations and double releases."""
import numpy as np
import pytest
import torch

from repro_torch.core.sparse_format import BlockSparseWeight
from repro_torch.kernels import build, launch_counts
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sparse_attention as sa
from repro_torch.kernels import sparse_gemv as gv
from repro_torch.models import lm
from repro_torch.serving import (ContinuousEngine, Fault, FaultPlan,
                                 SamplingParams, SpecConfig, panel_entry,
                                 release_entry, set_lane_entry)
from repro_torch.serving import sampling
from repro_torch.serving.faults import CANCEL_PREFILL, DOUBLE_RELEASE

from torch_parity import configs, sparse_params


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs("float32", kv_k_sparsity=0.3, kv_v_sparsity=0.5,
                         kv_tail=16)
    return tcfg, sparse_params(jcfg, tcfg)[1]


def _prompts(vocab, seed=0, lens=(21, 9, 30)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).tolist() for n in lens]


def _engine(params, cfg, **kw):
    return ContinuousEngine(params, cfg, slots=3, max_tokens=96, bs=16,
                            prefill_chunk=16, device="cpu", **kw)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.fixture(scope="module")
def live(setup):
    """Per pool kind, an engine past a refreeze with two slots decoding and
    one free; tests work on copies of its state."""
    cfg, params = setup
    engines = {}
    for paged in (False, True):
        eng = _engine(params, cfg, paged=paged)
        for p in _prompts(cfg.vocab)[:2]:
            eng.submit(p, SamplingParams(max_new_tokens=40))
        for _ in range(24):
            eng.step()
        assert len(eng.scheduler.decoding_slots()) == 2
        assert int(eng.state["prefix_blocks"].max()) >= 2
        engines[paged] = eng
    return engines


@pytest.mark.parametrize("qn", [1, 4], ids=["decode", "verify"])
@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_graph_logits_bit_equal_to_eager(setup, live, paged, qn):
    """Three ticks from copies of one live state: the captured forward's
    logits and the state it leaves equal the eager forward's bit for bit
    (the free slot masked in both)."""
    cfg, _ = setup
    eng = live[paged]
    slots = eng.scheduler.decoding_slots()
    mask = [s in slots for s in range(eng.pool.slots)]
    st_g, st_e = _clone(eng.state), _clone(eng.state)
    fwd = panel_entry(eng.params, st_g, cfg, eng.pool.bs, qn)
    rng = np.random.default_rng(qn)
    for _ in range(3):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab,
                                               (eng.pool.slots, qn)))
        fwd.set(tokens=tokens, mask=mask)
        got = fwd.run()
        want, _ = lm.forward_panel_pooled(
            eng.params, st_e, tokens, torch.tensor(mask), cfg, eng.pool.bs)
        assert torch.equal(got, want)
        assert _equal(st_g, st_e)
    assert fwd.captures == 1 and fwd.replays == 3


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_graphs_on_and_off_give_identical_tokens(setup, spec, paged):
    cfg, params = setup
    kw = dict(paged=paged, spec=SpecConfig(k=3) if spec else None)
    prompts = _prompts(cfg.vocab, seed=1, lens=(21, 9, 30))
    outs = []
    for graphs in (True, False):
        eng = _engine(params, cfg, graphs=graphs, **kw)
        rids = [eng.submit(p, SamplingParams(max_new_tokens=10))
                for p in prompts]
        res = eng.run()
        outs.append([(list(res[r].token_ids), list(res[r].logprobs))
                     for r in rids])
        name = "verify" if spec else "decode"
        assert eng.trace_counts()[name] == (1 if graphs else 0)
        assert eng.replay_counts()[name] > 5
    assert outs[0] == outs[1]


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_capture_leaves_the_state_untouched(setup, live, paged):
    """The capture runs the forward once with an all-false mask: no tail,
    length or table entry changes; the static output is one tensor, the
    same object every run."""
    cfg, _ = setup
    eng = live[paged]
    state, before = _clone(eng.state), _clone(eng.state)
    fwd = panel_entry(eng.params, state, cfg, eng.pool.bs, 2)
    assert _equal(state, before)
    assert not fwd.inputs["mask"].any() and fwd.out.shape == (
        eng.pool.slots, 2, cfg.vocab)
    out = fwd.out
    fwd.set(tokens=torch.zeros((eng.pool.slots, 2), dtype=torch.long),
            mask=[True, False, False])
    assert fwd.run() is out and fwd.run() is out
    assert int(state["tail_len"][0]) == int(before["tail_len"][0]) + 4
    assert torch.equal(state["tail_len"][1:], before["tail_len"][1:])


def test_replays_count_the_launches_the_graph_holds(setup, monkeypatch):
    """With the gemv and the unembedding counting a launch per call (as on
    the card), a decode entry's capture counts only its warm-up's real
    launches, each replay adds one gemv per linear and one unembedding,
    and a run with graphs counts what the eager run counts plus each
    entry's warm-up."""
    cfg, params = setup

    def counting(name, plain):
        fn = getattr(tops, name)

        def launch(*a, **k):
            fn.launches += 1
            return plain(*a, **k)
        monkeypatch.setattr(fn, "launches", 0)
        return launch
    monkeypatch.setattr(tops, "sparse_gemv", counting(
        "sparse_gemv", gv.sparse_gemv_plain))
    dense = tops._dense_kernel
    monkeypatch.setattr(tops, "_dense_kernel", counting(
        "_dense_kernel", lambda x, w, o=None: dense(x, w, o)))
    linears = 7 * cfg.n_layers
    counts = {}
    for graphs in (True, False):
        for fn in (gv.sparse_gemv, dense):
            fn.launches = 0
        eng = _engine(params, cfg, graphs=graphs)
        fwd = eng._entry("decode")
        assert fwd.held == ({"sparse_gemv": linears, "dense_matmul": 1}
                            if graphs else {})
        warm = linears if graphs else 0
        assert launch_counts()["sparse_gemv"] == warm
        # every prefill chunk longer than 8 rows: the gemv runs on decode
        # ticks alone
        rids = [eng.submit(p, SamplingParams(max_new_tokens=8))
                for p in _prompts(cfg.vocab, seed=2, lens=(25, 12, 30))]
        eng.run()
        assert all(len(eng.scheduler.finished[r].generated) == 8
                   for r in rids)
        c = launch_counts()
        ticks = eng.replay_counts()["decode"]
        # every entry's warm-up (the prefill chunk's per width class) ran
        # its kernels once, outside the counted replays
        warm_dense = sum(e.held.get("dense_matmul", 0)
                         for e in eng._entries.values())
        prefills = c["dense_matmul"] - ticks - warm_dense
        assert c["sparse_gemv"] == linears * ticks + warm and prefills > 0
        counts[graphs] = (c["sparse_gemv"] - warm,
                          c["dense_matmul"] - warm_dense, ticks)
    assert counts[True] == counts[False]


def test_replaced_state_tensor_raises(setup):
    """A transition that rebound a state key would leave the graph reading
    storage that is no longer the pool's: the next replay raises."""
    cfg, params = setup
    eng = _engine(params, cfg)
    fwd = eng._entry("decode")
    fwd.run()
    eng.state["pos"] = eng.state["pos"].clone()
    with pytest.raises(RuntimeError, match="replaced since the capture"):
        fwd.run()


def _capturing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)


def _meta_call(monkeypatch):
    monkeypatch.setattr(build, "require_cuda", lambda *t: t[0].device)
    monkeypatch.setattr(build, "ptr", lambda t: t)
    monkeypatch.setattr(build, "stream", lambda: None)
    monkeypatch.setattr(build, "call", lambda *a: None)


def _gemv_call(m=4, k=1024, n=2048):
    bk, bn = 256, 128
    sw = BlockSparseWeight(
        torch.empty((k // bk, n // bn, bk * bn // 32), dtype=torch.int32,
                    device="meta"),
        torch.empty((k // bk, n // bn, bk * bn // 2), dtype=torch.bfloat16,
                    device="meta"), None, (k, n), (bk, bn))
    return gv.sparse_gemv(torch.empty((m, k), dtype=torch.bfloat16,
                                      device="meta"), sw)


def _attention_call(b=4, qn=1, hkv=8, g=2, d=128, bs=128, sb=7, tp=128):
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    words = bs * d // 32
    return sa.sparse_decode_attention_fused(
        meta(b, hkv, qn * g, d), meta(b, hkv, sb, words, dtype=torch.int32),
        meta(b, hkv, sb, 8192), meta(b, hkv, sb, words, dtype=torch.int32),
        meta(b, hkv, sb, 8192), meta(b, hkv, tp, d), meta(b, hkv, tp, d),
        bs, d ** -0.5, meta(b, dtype=torch.int32),
        meta(b, dtype=torch.int32), group=g)


@pytest.mark.parametrize("wrapper", ["gemv", "attention"])
def test_buffer_growth_under_capture_raises(monkeypatch, wrapper):
    """A wrapper whose per-device scratch or tickets must be created or
    grown raises while the stream is being captured; once a warm-up at the
    same shapes sized them, the captured call goes through."""
    _meta_call(monkeypatch)
    monkeypatch.setattr(gv, "_SCRATCH", {})
    monkeypatch.setattr(sa, "_TICKETS", {})
    call = _gemv_call if wrapper == "gemv" else _attention_call
    with monkeypatch.context() as m:
        _capturing(m)
        with pytest.raises(RuntimeError, match="during a CUDA graph capture"):
            call()
    call()                                       # the warm-up sizes them
    held = (dict(gv._SCRATCH), dict(sa._TICKETS))
    with monkeypatch.context() as m:
        _capturing(m)
        call()
        if wrapper == "gemv":
            with pytest.raises(RuntimeError, match="gemv's scratch"):
                _gemv_call(k=1024 * 8)           # a larger plan: growth
        else:
            with pytest.raises(RuntimeError, match="attention's tickets"):
                _attention_call(b=160)
    assert (gv._SCRATCH, sa._TICKETS) == held


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_release_entry_bit_equal_to_eager(setup, live, paged):
    """From copies of a live state (two slots decoding, one free): the
    captured release leaves the state the eager ``pool.release`` leaves,
    for a live slot, a free slot (a masked no-op) and both at once; the
    capture with the all ``-1`` vector writes nothing."""
    eng = live[paged]
    st_g, st_e = _clone(eng.state), _clone(eng.state)
    before = _clone(st_g)
    fwd = release_entry(eng.pool, st_g)
    assert _equal(st_g, before) and fwd.captures == 1
    free = next(s for s in range(eng.pool.slots)
                if s not in eng.scheduler.active)
    live_slot = eng.scheduler.decoding_slots()[0]
    for slots in ([free], [live_slot], [live_slot, free]):
        vec = np.full(eng.pool.slots, -1, np.int32)
        vec[:len(slots)] = slots
        fwd.set(slots=vec)
        fwd.run()
        eng.pool.release(st_e, torch.from_numpy(vec))
        assert _equal(st_g, st_e)
    assert int(st_g["pos"][live_slot]) == 0
    if paged:
        assert int(st_g["refcount"].sum()) < int(before["refcount"].sum())
    assert fwd.replays == 3


def test_set_lane_entry_bit_equal_to_eager(setup):
    """The captured lane write equals the eager one for greedy, sampled
    and top-p lanes, and the capture (a false write flag) leaves every
    lane as it was."""
    lanes = sampling.init_lanes(3, torch.device("cpu"))
    lanes["temperature"][1] = 0.25
    ref = _clone(lanes)
    before = _clone(lanes)
    fwd = set_lane_entry(lanes)
    assert _equal(lanes, before) and fwd.captures == 1
    for slot, p in ((1, SamplingParams(temperature=0.7, top_k=40,
                                       top_p=0.9)),
                    (0, SamplingParams()),
                    (2, SamplingParams(temperature=1.3, top_p=0.55))):
        fwd.set(slot=[slot], temperature=[p.temperature], top_k=[p.top_k],
                top_p=[p.top_p])
        fwd.run()
        sampling.set_lane(
            ref, torch.tensor([slot]),
            torch.tensor([p.temperature], dtype=torch.float32),
            torch.tensor([p.top_k], dtype=torch.int32),
            torch.tensor([p.top_p], dtype=torch.float32),
            torch.ones(1, dtype=torch.bool))
        assert _equal(lanes, ref)
        assert lanes["temperature"][slot].item() == \
            np.float32(p.temperature)
        assert lanes["top_k"][slot].item() == p.top_k
    assert fwd.replays == 3


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_release_and_set_lane_captured_once_across_the_lifecycle(
        setup, paged):
    """Admissions, a cancel between ticks, a cancel mid-prefill and a
    double release: ``release`` and ``set_lane`` are captured once, when
    the engine is built, and replayed for every flush and admission; the
    double release is counted and the refcounts come back to zero."""
    cfg, params = setup
    plan = FaultPlan([Fault(CANCEL_PREFILL, 1), Fault(DOUBLE_RELEASE, 3)])
    eng = _engine(params, cfg, paged=paged, faults=plan, overlap=True)
    counts = eng.trace_counts()
    assert counts["release"] == counts["set_lane"] == 1
    prompts = _prompts(cfg.vocab, seed=2, lens=(40, 9, 21, 30, 12))
    rids = [eng.submit(p, SamplingParams(max_new_tokens=12))
            for p in prompts]
    for _ in range(6):
        eng.step()
    victim = next(r for r in rids if r not in eng.scheduler.finished)
    assert eng.cancel(victim)
    eng.run()
    assert plan.exhausted()
    assert eng.trace_counts() == counts
    replays = eng.replay_counts()
    assert replays["set_lane"] == len(prompts)
    assert replays["release"] >= 3
    fc = eng.fault_counters
    assert fc["cancelled"] == 2 and fc["double_release"] == 1
    assert not eng._slot_live.any()
    if paged:
        assert int(eng._alloc._ref.sum()) == 0
        assert int(eng.state["refcount"].sum()) == 0
