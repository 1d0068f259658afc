"""The prefill chunk, the refreeze and the prefix-hit assignment as captured
entries (``serving/engine.py::CapturedEntry``) on the CPU, where a
"capture" calls the entry on its static inputs.

Against the reference (reduced Qwen3, two layers, at f32, bridged weights,
1e-4): a
chunk padded to its width class ``W = 32`` at every valid length ``L`` in
{1, bs - 1, bs, bs + 1, W - 1, W} (``bs = 16``) gives the logits and the
state of the reference's unpadded chunk of length ``L``, flat and paged;
the device-mask ``refreeze`` and ``assign_blocks`` equal the reference's
transitions leaf for leaf, the slots they do not touch bit-identical.  In
the port: the captured entries bit-equal to the eager calls on copies of
one state; a capture leaves the state bit-identical; ``graphs=True`` and
``graphs=False`` give identical tokens, flat and paged, spec off and
``k = 3``, with ragged final chunks and unchunked; ``trace_counts()``
carries ``prefill_chunk`` (at most ``chunk // bs``), ``refreeze`` and
``assign``; and a non-final chunk, a refreeze and an assignment read no
tensor value on the host."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import NULL_CTX
from repro.models import lm as jlm
from repro.serving.cache_pool import CachePool as JaxPool

from repro_torch import bridge
from repro_torch.models import lm as tlm
from repro_torch.serving import (CachePool, ContinuousEngine, SamplingParams,
                                 SpecConfig, prefill_entry,
                                 stable_trace_counts)

from torch_parity import as_np, configs, rand, sparse_params, to_numpy

BS, W = 16, 32
LENGTHS = (1, BS - 1, BS, BS + 1, W - 1, W)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs("float32", kv_k_sparsity=0.3, kv_v_sparsity=0.5,
                         kv_tail=16, n_layers=2)
    jparams, tparams = sparse_params(jcfg, tcfg)
    return jcfg, tcfg, jparams, tparams


def _bridge(state):
    return bridge.state_from_numpy(to_numpy(state), "cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_matches(ref, got, exact=False):
    """Every leaf: integers (lengths, tables, refcounts, bitmap words)
    exactly, floats within ``TOL`` (or exactly)."""
    ref, got = _flat(ref), _flat(got)
    assert ref.keys() == got.keys()
    for k, a in ref.items():
        a, g = np.asarray(a), got[k]
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        if exact or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(g.numpy(), a, err_msg=k)
        else:
            np.testing.assert_allclose(as_np(g), a.astype(np.float64),
                                       err_msg=k, **TOL)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.fixture(scope="module")
def prefixed(setup):
    """Per pool kind, a reference pool state whose slot 1 holds one frozen
    16-token block (paged: on page 0), and the chunk's tokens."""
    jcfg, _, jparams, _ = setup
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (1, BS + W))
    out = {}
    for paged in (False, True):
        pool = JaxPool.build(jcfg, slots=2, max_tokens=96, bs=BS,
                             paged=paged)
        ids = {"new_ids": jnp.asarray([0], jnp.int32)} if paged else {}
        _, st = jax.jit(lambda p, s, t: jlm.forward_prefill_chunk(
            p, s, t, jnp.int32(1), jcfg, NULL_CTX, BS, **ids))(
                jparams, pool.init_state(), jnp.asarray(toks[:, :BS]))
        out[paged] = (st, toks[:, BS:])
    return out


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_padded_chunk_matches_the_reference(setup, prefixed, paged, length):
    """A ``W``-wide chunk of ``L`` valid tokens and ``W - L`` padding
    against the reference's ``L``-token chunk on the same state: the last
    valid token's logits within 1e-4, every state leaf (the blocks frozen
    at index < L // bs, the tail remainder, the lengths, the table and
    refcounts) as the reference leaves it.  Paged, the chunk is handed
    both fresh pages whatever ``L``: the one past ``L // bs`` stays
    unreferenced and unwritten."""
    jcfg, tcfg, jparams, tparams = setup
    jst, toks = prefixed[paged]
    nb = length // BS
    ids = {"new_ids": jnp.asarray([1, 2][:nb], jnp.int32)} if paged else {}
    ref_logits, ref = jax.jit(lambda p, s, t: jlm.forward_prefill_chunk(
        p, s, t, jnp.int32(1), jcfg, NULL_CTX, BS, **ids))(
            jparams, jst, jnp.asarray(toks[:, :length]))
    padded = np.zeros((1, W), np.int64)
    padded[0, :length] = toks[0, :length]
    kw = {"new_ids": torch.tensor([1, 2])} if paged else {}
    got_logits, got = tlm.forward_prefill_chunk(
        tparams, _bridge(jst), torch.from_numpy(padded), torch.tensor([1]),
        tcfg, BS, length=torch.tensor([length]), **kw)
    np.testing.assert_allclose(as_np(got_logits), as_np(ref_logits), **TOL)
    _assert_matches(ref, got)


def _full_tails(setup, paged):
    """Both pools with slots 0 and 2 full, slot 1 not, after one earlier
    fold on slot 2 (a nonzero prefix offset): reference and port states."""
    jcfg, tcfg, _, _ = setup
    jpool = JaxPool.build(jcfg, slots=3, max_tokens=96, bs=BS, paged=paged)
    pool = CachePool.build(tcfg, slots=3, max_tokens=96, bs=BS, paged=paged,
                           device="cpu")
    jst = dict(jpool.init_state())
    seed = 0
    for name, leaf in jst["layers"].items():
        kv = dict(leaf["kv"])
        for key in ("k_tail", "v_tail"):
            kv[key] = jnp.asarray(rand(kv[key].shape, seed))
            seed += 1
        jst["layers"] = {**jst["layers"], name: {"kv": kv}}
    jst["tail_len"] = jnp.asarray([16, 9, 16], jnp.int32)
    jst["pos"] = jnp.asarray([16, 9, 32], jnp.int32)
    jst["prefix_blocks"] = jnp.asarray([0, 0, 1], jnp.int32)
    if paged:
        jst["table"] = jst["table"].at[2, 0].set(4)
        jst["refcount"] = jst["refcount"].at[4].set(1)
    return jpool, pool, jst


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_refreeze_matches_the_reference(setup, paged):
    """The device-mask refreeze against the reference's: slots 0 and 2
    fold at their own offsets (paged: onto pages 3 and 6, the other rows
    of the id buffer zeros, as the engine leaves them), slot 1 comes back
    bit-identical; with the write flag false nothing changes."""
    jpool, pool, jst = _full_tails(setup, paged)
    ids = np.asarray([[3], [0], [6]], np.int64) if paged else None
    ref = dict(jax.jit(jpool.refreeze)(
        jst, *([jnp.asarray(ids, jnp.int32)] if paged else [])))
    st = _bridge(jst)
    before = _clone(st)
    pool.refreeze(st, None if ids is None else torch.from_numpy(ids),
                  torch.tensor([False]))
    assert _equal(st, before)
    pool.refreeze(st, None if ids is None else torch.from_numpy(ids))
    _assert_matches(ref, st)
    assert st["prefix_blocks"].tolist() == [1, 0, 2]
    for name, leaf in st["layers"].items():
        for key, a in leaf["kv"].items():
            b = before["layers"][name]["kv"][key]
            if key.endswith("tail") or not paged:
                assert torch.equal(a[:, 1], b[:, 1]), (name, key)
            else:                      # pages no full slot received
                keep = [i for i in range(pool.n_phys) if i not in (3, 6)]
                assert torch.equal(a[:, keep], b[:, keep]), (name, key)


def test_assign_blocks_matches_the_reference(setup):
    """A prefix hit through device operands (the slot, the ids at the
    table width, the count) against the reference's assignment; a false
    write flag changes nothing."""
    jpool, pool, jst = _full_tails(setup, True)
    ids = np.zeros(pool.max_blocks, np.int64)
    ids[:2] = [4, 5]
    ref = dict(jax.jit(jpool.assign_blocks)(
        jst, jnp.int32(1), jnp.asarray(ids, jnp.int32), jnp.int32(2)))
    st = _bridge(jst)
    before = _clone(st)
    args = (torch.tensor([1]), torch.from_numpy(ids), torch.tensor([2]))
    pool.assign_blocks(st, *args, torch.tensor([False]))
    assert _equal(st, before)
    pool.assign_blocks(st, *args)
    _assert_matches(ref, st, exact=True)
    assert st["refcount"][[4, 5]].tolist() == [2, 1]


def _engine(params, cfg, **kw):
    kw = {"slots": 3, "max_tokens": 96, "bs": BS, "prefill_chunk": W,
          "device": "cpu", **kw}
    return ContinuousEngine(params, cfg, **kw)


def _prompts(vocab, seed=0, lens=(41, 9, 30, 16)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).tolist() for n in lens]


@pytest.fixture(scope="module")
def live(setup):
    """Per pool kind, an engine past a refreeze with slots decoding; tests
    work on copies of its state."""
    _, cfg, _, params = setup
    engines = {}
    for paged in (False, True):
        eng = _engine(params, cfg, paged=paged)
        for p in _prompts(cfg.vocab)[:2]:
            eng.submit(p, SamplingParams(max_new_tokens=40))
        for _ in range(22):
            eng.step()
        assert int(eng.state["prefix_blocks"].max()) >= 2
        engines[paged] = eng
    return engines


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_chunk_entry_bit_equal_to_eager(setup, live, paged):
    """Into the free slot, from copies of one live state: a ragged chunk
    (17 of 32) then a full-width one, through the captured entry and
    through the eager call on the same padded operands: logits and the
    whole state bit-equal; the capture itself left the state as it was."""
    eng = live[paged]
    slot = next(s for s in range(eng.pool.slots)
                if s not in eng.scheduler.active)
    st_g, st_e = _clone(eng.state), _clone(eng.state)
    fwd = prefill_entry(eng.params, st_g, eng.cfg, BS, W)
    assert _equal(st_g, st_e)
    rng = np.random.default_rng(1)
    free = ([i for i in range(eng.pool.n_phys)
             if eng._alloc.refcount(i) == 0][-4:] if paged else [])
    for n, ids in ((17, free[:2]), (W, free[2:])):
        toks = np.zeros((1, W), np.int64)
        toks[0, :n] = rng.integers(0, eng.cfg.vocab, n)
        vals = {"tokens": toks, "slot": [slot], "length": [n]}
        if paged:
            vals["ids"] = ids
        fwd.set(**vals)
        got = fwd.run()
        want, _ = tlm.forward_prefill_chunk(
            eng.params, st_e, torch.from_numpy(toks), torch.tensor([slot]),
            eng.cfg, BS, new_ids=torch.tensor(ids) if paged else None,
            length=torch.tensor([n]))
        assert torch.equal(got, want)
        assert _equal(st_g, st_e)
    assert fwd.captures == 1 and fwd.replays == 2
    assert int(st_g["prefix_blocks"][slot]) == 3


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_capture_leaves_the_state_untouched(setup, live, paged):
    """Capturing the engine's prefill entries (both width classes), its
    refreeze and, paged, its assignment on the live state (each warm-up
    and capture with the write flag false) changes no state tensor."""
    eng = live[paged]
    before = _clone(eng.state)
    saved, eng._entries = eng._entries, {}
    try:
        for w in (BS, W):
            eng._entry("prefill_chunk", w)
        eng._entry("refreeze")
        if paged:
            eng._entry("assign")
        assert all(e.captures == 1 for e in eng._entries.values())
        assert _equal(eng.state, before)
    finally:
        eng._entries = saved


CASES = [(False, 0, W), (True, 0, W), (False, 3, W), (True, 3, W),
         (False, 0, None), (True, 3, None)]
CASE_IDS = ["flat", "paged", "flat-k3", "paged-k3", "flat-unchunked",
            "paged-k3-unchunked"]


@pytest.mark.parametrize("paged,k,chunk", CASES, ids=CASE_IDS)
def test_graphs_on_and_off_give_identical_tokens(setup, paged, k, chunk):
    """Ragged prompts (41 = 32 + 9, 9, 30, 16) through the captured entries
    and eagerly: identical tokens and logprobs; the chunk's width classes
    are multiples of the block (unchunked: power-of-two block counts)."""
    _, cfg, _, params = setup
    outs, counts = [], []
    for graphs in (True, False):
        eng = _engine(params, cfg, paged=paged, prefill_chunk=chunk,
                      spec=SpecConfig(k=k) if k else None, graphs=graphs)
        rids = [eng.submit(p, SamplingParams(max_new_tokens=12))
                for p in _prompts(cfg.vocab, seed=2)]
        res = eng.run()
        outs.append([(list(res[r].token_ids), list(res[r].logprobs))
                     for r in rids])
        counts.append(eng.trace_counts())
        assert eng.replay_counts()["prefill_chunk"] == (5 if chunk else 4)
    assert outs[0] == outs[1]
    # unchunked, 41 tokens take 4 blocks (a power of two): class 64
    widths = {W: {BS, W}, None: {BS, W, 64}}[chunk]
    assert counts[0]["prefill_chunk"] == len(widths)
    assert all(v == 0 for v in counts[1].values())


def test_trace_counts_stay_flat_across_the_lifecycle(setup):
    """Two waves of shared-prefix prompts through the paged overlapped
    engine: after every tick each stable entry (decode, refreeze, assign)
    has at most one capture and ``prefill_chunk`` at most ``chunk // bs``;
    at the end every entry was captured once and replayed."""
    _, cfg, _, params = setup
    eng = _engine(params, cfg, paged=True, overlap=True)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab, W).tolist()
    for wave in range(2):
        for n in (9, 20, 5):
            eng.submit(shared + rng.integers(0, cfg.vocab, n).tolist(),
                       SamplingParams(max_new_tokens=18))
        while not eng.scheduler.done():
            eng.step()
            counts = eng.trace_counts()
            assert counts["prefill_chunk"] <= W // BS
            assert all(v <= 1 for v in stable_trace_counts(counts).values())
        eng.quiesce()
    assert eng.trace_counts() == {"decode": 1, "prefill_chunk": 2,
                                  "refreeze": 1, "release": 1,
                                  "set_lane": 1, "assign": 1}
    assert set(eng.replay_counts()) == {"decode", "prefill_chunk",
                                        "refreeze", "release", "set_lane",
                                        "assign"}
    assert eng.replay_counts()["assign"] >= 3


@pytest.mark.parametrize("paged,k", [(False, 0), (True, 0), (True, 3)],
                         ids=["flat", "paged", "paged-k3"])
def test_chunked_engine_captures_every_entry_when_built(setup, paged, k):
    """A chunked engine captures every entry its ticks can run when it is
    built (the forward its ticks use, each chunk width class, the refreeze,
    the release, the lane write and, paged, the assignment), leaving the state as an engine without
    graphs starts it; serving then captures nothing more."""
    _, cfg, _, params = setup
    kw = dict(paged=paged, spec=SpecConfig(k=k) if k else None)
    eng = _engine(params, cfg, **kw)
    want = {"decode": int(not k), "prefill_chunk": W // BS, "refreeze": 1,
            "release": 1, "set_lane": 1}
    if paged:
        want["assign"] = 1
    if k:
        want["verify"] = 1
    assert eng.trace_counts() == want
    assert eng.replay_counts() == {n: 0 for n, c in want.items() if c}
    assert _equal(eng.state, _engine(params, cfg, graphs=False, **kw).state)
    for p in _prompts(cfg.vocab, seed=5):
        eng.submit(p, SamplingParams(max_new_tokens=20))
    eng.run()
    assert eng.trace_counts() == want


def test_unchunked_width_classes_are_powers_of_two(setup):
    """Unchunked, a prompt of n tokens runs in a class of a power-of-two
    count of blocks, capped at the slot's blocks: at 6 blocks of 16 the
    classes are 16, 32, 64 and 96, which ``warmup`` captures and no prompt
    adds to."""
    _, cfg, _, params = setup
    eng = _engine(params, cfg, prefill_chunk=None)
    assert eng.pool.max_blocks == 6 and eng.trace_counts()["prefill_chunk"] == 0
    widths = {n: eng._width(n) for n in range(1, eng.pool.capacity_tokens + 1)}
    assert sorted(set(widths.values())) == [BS, 2 * BS, 4 * BS, 6 * BS]
    assert all(w >= n for n, w in widths.items())
    assert (widths[33], widths[64], widths[65]) == (64, 64, 96)
    eng.warmup()
    assert eng.trace_counts()["prefill_chunk"] == 4
    for p in _prompts(cfg.vocab, seed=6, lens=(70, 3, 40)):
        eng.submit(p, SamplingParams(max_new_tokens=4))
    eng.run()
    assert eng.trace_counts()["prefill_chunk"] == 4


def test_set_copies_a_host_value_once(setup, monkeypatch):
    """``CapturedEntry.set`` copies a host value (a list or an array) only
    when it differs from the last one written to that input; a tensor is
    always copied."""
    from repro_torch.serving import engine as eng_mod
    _, cfg, _, params = setup
    eng = _engine(params, cfg)
    fwd = eng._entry("decode")
    copied = []
    stage = eng_mod._stage

    def counted(dst, value):
        copied.append(next(k for k, t in fwd.inputs.items() if t is dst))
        stage(dst, value)
    monkeypatch.setattr(eng_mod, "_stage", counted)
    toks = torch.zeros((eng.pool.slots, 1), dtype=torch.long)
    fwd.set(tokens=toks, mask=[True, False, True])
    fwd.set(tokens=toks, mask=[True, False, True])
    fwd.set(mask=np.array([True, False, True]))
    fwd.set(mask=[False, False, True])
    assert copied == ["tokens", "mask", "tokens", "mask"]
    assert fwd.inputs["mask"].tolist() == [False, False, True]


HOST_READS = ("item", "tolist", "nonzero", "cpu", "numpy")


@pytest.mark.parametrize("paged,overlap", [(False, True), (True, False)],
                         ids=["flat-overlap", "paged"])
def test_no_host_read_in_chunk_refreeze_or_assignment(setup, monkeypatch,
                                                      paged, overlap):
    """While a non-final chunk, a refreeze or an admission with a prefix
    hit runs (every entry captured when the engine was built), every host
    read of a tensor value raises."""
    _, cfg, _, params = setup
    eng = _engine(params, cfg, paged=paged, overlap=overlap)
    ran = {"chunk": 0, "refreeze": 0, "assign": 0}
    guard = {"on": False}
    for name in HOST_READS:
        orig = getattr(torch.Tensor, name)

        def read(self, *a, _orig=orig, _name=name, **k):
            if guard["on"]:
                raise AssertionError(f"host read .{_name}() in a dispatch "
                                     "that must not wait for the device")
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, read)

    def guarded(key, fn, when):
        def run(*a, **k):
            on = when()
            if on:
                ran[key] += 1
            guard["on"] = on
            try:
                return fn(*a, **k)
            finally:
                guard["on"] = False
        return run

    def non_final():
        req = eng.scheduler.next_prefill()
        return (req is not None
                and len(req.prompt) - req.prefill_done > eng.scheduler.chunk)

    def folds():
        return any(t >= eng.pool.tail for t in eng._tail_len)

    eng._prefill_tick = guarded("chunk", eng._prefill_tick, non_final)
    eng._refreeze_tick = guarded("refreeze", eng._refreeze_tick, folds)
    if paged:
        eng._admit_paged = guarded("assign", eng._admit_paged, lambda: True)
    rng = np.random.default_rng(4)
    shared = rng.integers(0, cfg.vocab, W).tolist()
    prompts = [shared + rng.integers(0, cfg.vocab, n).tolist()
               for n in (40, 7, 19)]
    eng.submit(prompts[0], SamplingParams(max_new_tokens=20))
    for _ in range(3):
        eng.step()
    for p in prompts[1:]:
        eng.submit(p, SamplingParams(max_new_tokens=20))
    eng.run()
    assert ran["chunk"] >= 2 and ran["refreeze"] >= 2
    if paged:
        assert ran["assign"] >= 3 and eng.replay_counts()["assign"] >= 2
