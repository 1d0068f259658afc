"""The port's paged shared-prefix pool against the reference (mirrors
``tests/test_paged_pool.py``): the paged attention's plain version against
the paged Pallas kernel in interpret mode, dead arena pages never read,
the pool's table / refcount transitions state for state, the host
allocator and prefix trie, and the paged engine — token-identical to the
flat engine, and on int8 weights to the reference's paged engine."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # container ships without hypothesis
    class _St:
        def integers(self, *a, **k): return None
        def lists(self, *a, **k): return None
    st = _St()

    def settings(**_kw):
        return lambda fn: fn

    def given(**_kw):
        def deco(fn):
            @pytest.mark.skip(reason="hypothesis not installed")
            def wrapper():
                pass
            wrapper.__name__ = fn.__name__
            return wrapper
        return deco

from repro.configs import get_config as jax_config
from repro.core.sparse_kv import freeze_chunk_blocks
from repro.distributed import NULL_CTX
from repro.distributed.convert_plan import convert_concrete as jax_convert
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.serving import BlockAllocator as JaxAllocator
from repro.serving import CachePool as JaxPool
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import PrefixTrie as JaxTrie
from repro.serving import SamplingParams as JaxParams
from repro.serving import block_hashes as jax_block_hashes

from repro_torch import bridge
from repro_torch.configs import get_config as torch_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels.sparse_attention import \
    sparse_decode_attention_fused_paged
from repro_torch.serving import ContinuousEngine, SamplingParams
from repro_torch.serving.cache_pool import BlockAllocator, CachePool
from repro_torch.serving.scheduler import PrefixTrie, block_hashes

from torch_parity import configs, rand, to_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return bridge.tensor_from_numpy(np.asarray(a), "cpu")


# ---------------------------------------------------------------------------
# kernel: table indirection vs the paged Pallas kernel
# ---------------------------------------------------------------------------

def _arena_case(n_phys=10, hkv=2, bs=16, d=32, ks=0.3, vs=0.5, seed=0):
    """A frozen arena of ``n_phys`` independent compressed blocks, as the
    reference's test builds it: reference arrays + the port's copies."""
    k = jnp.asarray(rand((n_phys, hkv, bs, d), seed))
    v = jnp.asarray(rand((n_phys, hkv, bs, d), seed + 1))
    cap = bs * d
    arena = tuple(a[:, :, 0] for a in freeze_chunk_blocks(k, v, ks, vs, bs,
                                                          cap, cap))
    return arena, tuple(_t(a) for a in arena)


# the tables share physical pages across slots on purpose
PAGED_GRID = [
    # (table rows, prefix_blocks, tail_len)  b=4, sb=4
    pytest.param([[0, 1, 2, 3], [0, 1, 2, 3], [0, 1, 2, 3], [0, 1, 2, 3]],
                 [4, 4, 4, 4], [1, 9, 14, 16], id="all_shared"),
    pytest.param([[0, 1, 2, 3], [0, 1, 5, 6], [7, 8, 0, 0], [9, 0, 0, 0]],
                 [4, 4, 2, 1], [1, 5, 9, 13], id="cow_divergence"),
    pytest.param([[0, 1, 2, 3], [0, 1, 9, 9], [0, 0, 0, 0], [5, 6, 7, 8]],
                 [2, 2, 0, 4], [3, 14, 7, 1], id="dead_entries"),
    pytest.param([[0, 0, 0, 0]] * 4, [0, 0, 0, 0], [1, 4, 9, 16],
                 id="empty_prefix"),
]
B, HKV, G, D, BS, T = 4, 2, 2, 32, 16, 16


@pytest.mark.parametrize("table,prefix_blocks,tail_len", PAGED_GRID)
@pytest.mark.parametrize("qn", [0, 3])
def test_paged_plain_matches_pallas(table, prefix_blocks, tail_len, qn):
    """Decode ticks and 3-query panels, slots sharing pages, dead in-range
    table entries: the port's paged entry (plain version on the CPU)
    against the reference's paged Pallas kernel in interpret mode."""
    jarena, tarena = _arena_case(hkv=HKV, bs=BS, d=D)
    tl = np.asarray(tail_len, np.int32)
    if qn:                          # panel query j sees tail_len + j
        tl = np.minimum(tl, T - (qn - 1))
    pl_ = np.asarray(prefix_blocks, np.int32) * BS
    tbl = np.asarray(table, np.int32)
    k_tail, v_tail = rand((B, HKV, T, D), 10), rand((B, HKV, T, D), 11)
    q = rand((B, HKV * G, D) if qn == 0 else (B, qn, HKV * G, D), 12)
    sm = 1.0 / D ** 0.5
    with jops.backend("interpret"):
        ref = jops.sparse_decode_attention_paged(
            jnp.asarray(q), *jarena, jnp.asarray(tbl), HKV, sm, BS,
            jnp.asarray(k_tail), jnp.asarray(v_tail), jnp.asarray(tl),
            jnp.asarray(pl_))
    before = sparse_decode_attention_fused_paged.launches
    got = tops.sparse_decode_attention_paged(
        torch.from_numpy(q), *tarena, torch.from_numpy(tbl), HKV, sm, BS,
        torch.from_numpy(k_tail), torch.from_numpy(v_tail),
        torch.from_numpy(tl), torch.from_numpy(pl_))
    assert sparse_decode_attention_fused_paged.launches == before
    assert got.shape == tuple(np.asarray(ref).shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("poison", ["huge", "nan"])
def test_poisoned_arena_pages_never_read(poison):
    """Poison every page not referenced by a live table entry (including
    the pages dead entries point at), with huge values or NaN: the output
    is bit-identical to the clean arena's, and the clean output matches the
    reference kernel's."""
    n_phys = 10
    jarena, tarena = _arena_case(n_phys=n_phys, hkv=HKV, bs=BS, d=D)
    table = np.asarray([[0, 1, 2, 3], [0, 1, 9, 9],
                        [4, 0, 0, 0], [5, 5, 5, 5]], np.int32)
    prefix_blocks = np.asarray([4, 2, 1, 0], np.int32)
    live = {int(table[s, i]) for s in range(B)
            for i in range(prefix_blocks[s])}
    dead = torch.tensor([p not in live for p in range(n_phys)])
    assert dead.any()
    fill = 1e4 if poison == "huge" else float("nan")
    poisoned = tuple(
        torch.where(dead[:, None, None],
                    torch.full_like(a, -1) if a.dtype == torch.int32
                    else torch.full_like(a, fill), a)
        for a in tarena)
    tl = np.asarray([1, 9, 16, 4], np.int32)
    k_tail, v_tail = rand((B, HKV, T, D), 20), rand((B, HKV, T, D), 21)
    q = rand((B, HKV * G, D), 22)
    sm = 1.0 / D ** 0.5
    args = (torch.from_numpy(table), HKV, sm, BS, torch.from_numpy(k_tail),
            torch.from_numpy(v_tail), torch.from_numpy(tl),
            torch.from_numpy(prefix_blocks * BS))
    clean = tops.sparse_decode_attention_paged(torch.from_numpy(q), *tarena,
                                               *args)
    dirty = tops.sparse_decode_attention_paged(torch.from_numpy(q),
                                               *poisoned, *args)
    assert torch.isfinite(dirty).all()
    assert torch.equal(clean, dirty)
    with jops.backend("interpret"):
        ref = jops.sparse_decode_attention_paged(
            jnp.asarray(q), *jarena, jnp.asarray(table), HKV, sm, BS,
            jnp.asarray(k_tail), jnp.asarray(v_tail), jnp.asarray(tl),
            jnp.asarray(prefix_blocks * BS))
    np.testing.assert_allclose(clean.numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# pool transitions: table / refcount bookkeeping, state for state
# ---------------------------------------------------------------------------

def _cfgs(**kw):
    kw = dict(kv_k_sparsity=0.0, kv_v_sparsity=0.0, kv_tail=16,
              compute_dtype="float32", param_dtype="float32", **kw)
    return (dataclasses.replace(jax_config("qwen3-0.6b").reduced(), **kw),
            dataclasses.replace(torch_config("qwen3-0.6b").reduced(), **kw))


def _pools(slots=3, bs=16, max_tokens=64, n_phys=0, paged=True):
    jcfg, tcfg = _cfgs()
    return (JaxPool.build(jcfg, slots=slots, max_tokens=max_tokens, bs=bs,
                          paged=paged, n_phys=n_phys),
            CachePool.build(tcfg, slots=slots, max_tokens=max_tokens, bs=bs,
                            paged=paged, n_phys=n_phys, device="cpu"))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_same_state(jstate, tstate, keys=None):
    jf, tf = _flat(dict(jstate)), _flat(tstate)
    assert set(jf) == set(tf)
    for k in keys or jf:
        ref = np.asarray(jf[k])
        if ref.dtype == np.uint32:
            ref = ref.view(np.int32)
        np.testing.assert_array_equal(tf[k].numpy(), ref, err_msg=k)


def test_paged_build_defaults_and_errors():
    jpool, pool = _pools(slots=3, max_tokens=64, bs=16)
    assert pool.paged and pool.n_phys == jpool.n_phys == 3 * pool.max_blocks
    st0, jst0 = pool.init_state(), jpool.init_state()
    assert st0["table"].shape == (3, pool.max_blocks)
    assert st0["refcount"].shape == (pool.n_phys,)
    _assert_same_state(jst0, st0)            # every leaf: shape and zeros
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="not a multiple"):
        CachePool.build(tcfg, 2, 64, bs=12, device="cpu")
    with pytest.raises(ValueError, match="paged-pool"):
        CachePool.build(tcfg, 2, 64, device="cpu").assign_blocks(
            {}, 0, [0], 1)


def _fill_tails(jstate, tstate, fill, seed):
    """Write the same random K/V into both pools' tail rings and set the
    tail lengths to ``fill``."""
    for name, leaf in tstate["layers"].items():
        for key in ("k_tail", "v_tail"):
            a = rand(tuple(leaf["kv"][key].shape), seed)
            seed += 1
            leaf["kv"][key].copy_(torch.from_numpy(a))
            jkv = dict(jstate["layers"][name]["kv"])
            jkv[key] = jnp.asarray(a)
            jstate["layers"] = {**jstate["layers"], name: {"kv": jkv}}
    fill = np.asarray(fill, np.int32)
    tstate["tail_len"].copy_(torch.from_numpy(fill))
    tstate["pos"] += torch.from_numpy(fill)
    jstate["tail_len"] = jnp.asarray(fill)
    jstate["pos"] = jstate["pos"] + jnp.asarray(fill)
    return jstate


def test_assign_refreeze_release_refcount_bookkeeping():
    """One shared-prefix lifetime on both pools, compared leaf for leaf
    after every transition: slot 0 freezes two pages, slot 1 takes a shared
    reference (admission hit), slot 1 diverges onto a fresh page (CoW),
    then a batched release drops both slots and every refcount returns to
    zero."""
    jpool, pool = _pools(slots=3)
    tb = pool.tail // pool.bs
    jst, st = dict(jpool.init_state()), pool.init_state()

    for newpage in range(2):
        jst = _fill_tails(jst, st, [16, 0, 0], seed=10 * newpage)
        ids = np.zeros((pool.slots, tb), np.int32)
        ids[0] = [newpage]
        jst = dict(jax.jit(jpool.refreeze)(jst, jnp.asarray(ids)))
        pool.refreeze(st, ids)
        _assert_same_state(jst, st)
    assert st["prefix_blocks"].tolist() == [2, 0, 0]
    assert st["table"][0, :2].tolist() == [0, 1]
    assert st["refcount"][:2].tolist() == [1, 1]

    pad = np.zeros(pool.max_blocks, np.int32)
    pad[:2] = [0, 1]
    jst = dict(jax.jit(jpool.assign_blocks)(jst, jnp.int32(1),
                                            jnp.asarray(pad), jnp.int32(2)))
    pool.assign_blocks(st, 1, pad, 2)
    _assert_same_state(jst, st)
    assert st["refcount"][:2].tolist() == [2, 2]
    assert st["pos"].tolist() == [32, 32, 0]

    shared = [st["layers"]["l0"]["kv"][k][:, :2].clone()
              for k in ("k_bitmap", "k_values")]
    jst = _fill_tails(jst, st, [0, 16, 0], seed=30)
    ids = np.zeros((pool.slots, tb), np.int32)
    ids[1] = [2]
    jst = dict(jax.jit(jpool.refreeze)(jst, jnp.asarray(ids)))
    pool.refreeze(st, ids)
    _assert_same_state(jst, st)
    assert st["table"][1, :3].tolist() == [0, 1, 2]
    assert st["refcount"][:3].tolist() == [2, 2, 1]
    for before, key in zip(shared, ("k_bitmap", "k_values")):
        assert torch.equal(before, st["layers"]["l0"]["kv"][key][:, :2]), \
            f"CoW wrote shared {key} pages"

    rel = np.full(pool.slots, -1, np.int32)
    rel[:2] = [0, 1]
    jst = dict(jax.jit(jpool.release)(jst, jnp.asarray(rel)))
    pool.release(st, torch.from_numpy(rel))
    _assert_same_state(jst, st)
    assert int(st["refcount"].sum()) == 0 and int(st["table"].sum()) == 0


def test_bridge_carries_a_paged_pool_state():
    """A reference paged pool state (arena leaves with uint32 bitmap words,
    table, refcount) crosses the bridge leaf for leaf, and the port's pool
    transitions continue from it exactly as the reference's do."""
    jpool, pool = _pools(slots=3)
    tb = pool.tail // pool.bs
    jst, st = dict(jpool.init_state()), pool.init_state()
    jst = _fill_tails(jst, st, [16, 16, 0], seed=40)
    ids = np.asarray([[3], [5], [0]], np.int32)
    jst = dict(jax.jit(jpool.refreeze)(jst, jnp.asarray(ids)))
    bridged = bridge.state_from_numpy(to_numpy(jst), "cpu")
    assert bridged["layers"]["l0"]["kv"]["k_bitmap"].dtype == torch.int32
    assert bridged["table"].dtype == bridged["refcount"].dtype == torch.int32
    _assert_same_state(jst, bridged)
    pad = np.zeros(pool.max_blocks, np.int32)
    pad[:1] = [3]
    jst = dict(jax.jit(jpool.assign_blocks)(jst, jnp.int32(2),
                                            jnp.asarray(pad), jnp.int32(1)))
    pool.assign_blocks(bridged, 2, pad, 1)
    _assert_same_state(jst, bridged)
    assert bridged["refcount"][[3, 5]].tolist() == [2, 1]
    del tb


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_release_vector_matches_scalar_loop(paged):
    """Batched release == the scalar loop it replaces, and == the
    reference's batched release."""
    jpool, pool = _pools(slots=4, paged=paged)

    def state():
        st = pool.init_state()
        st["pos"].copy_(torch.tensor([5, 9, 3, 7]))
        st["tail_len"].copy_(torch.tensor([5, 9, 3, 7]))
        if paged:
            st["prefix_blocks"].copy_(torch.tensor([2, 1, 0, 0]))
            st["table"][0, :2] = torch.tensor([3, 4])
            st["table"][1, 0] = 5
            st["refcount"][[3, 4, 5]] = 1
        return st
    vec = torch.tensor([0, 2, -1, -1], dtype=torch.int32)
    batched = pool.release(state(), vec)
    looped = pool.release(pool.release(state(), 0), 2)
    bf, lf = _flat(batched), _flat(looped)
    for k in bf:
        assert torch.equal(bf[k], lf[k]), k
    jst = jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), state())
    _assert_same_state(jpool.release(jst, jnp.asarray(vec.numpy())), batched)


@pytest.fixture(scope="module")
def walk_pools():
    jpool, pool = _pools(slots=3)
    return (jpool, pool, jax.jit(jpool.refreeze),
            jax.jit(jpool.assign_blocks), jax.jit(jpool.release))


@settings(max_examples=25, deadline=None)
@given(ops_seq=st.lists(st.integers(min_value=0, max_value=99),
                        min_size=1, max_size=12))
def test_refcount_conservation_property(walk_pools, ops_seq):
    """Any admit / refreeze(CoW) / release walk conserves refcounts
    (``sum(refcount) == live table entries``), the device vector mirrors
    the host allocator, nothing double-frees, and the port's table and
    refcount equal the reference pool's after every transition."""
    jpool, pool, jrefreeze, jassign, jrelease = walk_pools
    tb = pool.tail // pool.bs
    alloc = BlockAllocator(pool.n_phys)
    jst, st = dict(jpool.init_state()), pool.init_state()
    blocks = {}                                   # slot -> [ids]

    def check():
        rc = st["refcount"].numpy()
        assert rc.sum() == sum(len(v) for v in blocks.values())
        assert rc.min() >= 0
        for bid in range(pool.n_phys):
            assert rc[bid] == alloc.refcount(bid), bid
        for ids in blocks.values():
            assert all(rc[b] > 0 for b in ids)
        _assert_same_state(jst, st, keys=["/table", "/refcount", "/pos",
                                          "/prefix_blocks", "/tail_len"])

    for code in ops_seq:
        op, arg = code % 3, code // 3
        if op == 0:       # grow a slot: fill its tail, refreeze onto fresh
            slot = arg % pool.slots
            if (len(blocks.get(slot, ())) + tb > pool.max_blocks
                    or alloc.free_blocks() < tb):
                continue
            tl = np.zeros(pool.slots, np.int32)
            tl[slot] = pool.tail
            fresh = alloc.alloc(tb)
            ids = np.zeros((pool.slots, tb), np.int32)
            ids[slot] = fresh
            st["tail_len"].copy_(torch.from_numpy(tl))
            st["pos"] += torch.from_numpy(tl)
            jst = dict(jst, tail_len=jnp.asarray(tl),
                       pos=jst["pos"] + jnp.asarray(tl))
            pool.refreeze(st, ids)
            jst = dict(jrefreeze(jst, jnp.asarray(ids)))
            blocks.setdefault(slot, []).extend(fresh)
        elif op == 1:     # admit a free slot on a hit over another's prefix
            free = [s for s in range(pool.slots) if s not in blocks]
            donors = [s for s in blocks if blocks[s]]
            if not free or not donors:
                continue
            slot, donor = free[0], donors[arg % len(donors)]
            n = arg % len(blocks[donor]) + 1
            hits = blocks[donor][:n]
            alloc.incref(hits)
            pad = np.zeros(pool.max_blocks, np.int32)
            pad[:n] = hits
            pool.assign_blocks(st, slot, pad, n)
            jst = dict(jassign(jst, jnp.int32(slot), jnp.asarray(pad),
                               jnp.int32(n)))
            blocks[slot] = list(hits)
        else:             # release a subset of live slots in one call
            live_slots = sorted(blocks)
            if not live_slots:
                continue
            picked = live_slots[:arg % len(live_slots) + 1]
            vec = np.full(pool.slots, -1, np.int32)
            vec[:len(picked)] = picked
            pool.release(st, torch.from_numpy(vec))
            jst = dict(jrelease(jst, jnp.asarray(vec)))
            for s in picked:
                alloc.decref(blocks.pop(s))
        check()


# ---------------------------------------------------------------------------
# host side: allocator + prefix trie
# ---------------------------------------------------------------------------

def _allocator_walk(cls):
    evicted, log = [], []
    alloc = cls(3, on_evict=evicted.append)
    a, b, c = alloc.alloc(3)
    alloc.register(a, 100)
    alloc.register(b, 200)
    log.append(alloc.free_blocks())
    alloc.decref([a, b])          # both park in the LRU, oldest = a
    log += [alloc.free_blocks(), alloc.lookup(100), alloc.lookup(200)]
    alloc.incref([b])             # revive b out of the LRU
    [d] = alloc.alloc(1)          # must evict a (cold end), never b or c
    log += [d, list(evicted), alloc.lookup(100), alloc.lookup(200)]
    alloc.decref([c])             # unregistered: straight to the free list
    log.append(alloc.free_blocks())
    with pytest.raises(RuntimeError, match="double free"):
        alloc.decref([c])
    with pytest.raises(RuntimeError, match="exhausted"):
        alloc.alloc(2)            # only 1 reclaimable (b, d live)
    return (a, b, c), log


def test_block_allocator_lru_eviction_and_revival():
    (a, b, c), log = _allocator_walk(BlockAllocator)
    assert log[:4] == [0, 2, a, b]
    assert log[4:8] == [a, [100], None, b]
    assert log[8] == 1
    assert _allocator_walk(JaxAllocator) == ((a, b, c), log)


def test_block_hashes_chain_and_trie_match():
    bs = 4
    a = list(range(12))
    b = list(range(8)) + [99, 98, 97, 96]
    ha, hb = block_hashes(a, bs), block_hashes(b, bs)
    assert ha == jax_block_hashes(a, bs) and hb == jax_block_hashes(b, bs)
    assert len(ha) == 3 and ha[:2] == hb[:2] and ha[2] != hb[2]
    assert block_hashes(a[:11], bs) == ha[:2]
    assert block_hashes(a[4:8], bs)[0] != ha[1]
    for trie in (PrefixTrie(), JaxTrie()):
        for i, h in enumerate(ha):
            trie.insert(h, i + 10)
        assert trie.match(hb) == [10, 11]
        assert trie.match(block_hashes([7] * 8, bs)) == []
        trie.drop(ha[1])                      # eviction invalidates mid-chain
        assert trie.match(ha) == [10]
        assert len(trie) == 2


# ---------------------------------------------------------------------------
# engine: token identity
# ---------------------------------------------------------------------------

def _params(mode, seed=0):
    """f32 reduced qwen3 with the reference's KV sparsity; one reference
    init + conversion, bridged."""
    jcfg, tcfg = configs("float32", kv_k_sparsity=0.3, kv_v_sparsity=0.5,
                         kv_tail=16)
    jparams = jax.jit(lambda key: jax_convert(
        jlm.init_params(jcfg, key), jlm.model_specs(jcfg), jcfg, NULL_CTX,
        mode=mode))(jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, bridge.params_from_numpy(
        to_numpy(jparams), tcfg, "cpu")


def _shared_wave(vocab, seed=0):
    """A 64-token shared prefix with unique suffixes (prefix-cache hits), a
    divergence inside the shared region (CoW at block 2), an unrelated
    prompt."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, (64,)).tolist()
    return [
        shared + rng.integers(0, vocab, (5,)).tolist(),
        shared + rng.integers(0, vocab, (9,)).tolist(),
        shared[:32] + rng.integers(0, vocab, (20,)).tolist(),
        rng.integers(0, vocab, (40,)).tolist(),
    ]


def _drive(eng, prompts, params_cls, steps=24):
    rids = [eng.submit(p, params_cls(max_new_tokens=steps)) for p in prompts]
    res = eng.run()
    return [list(res[r].token_ids) for r in rids], res


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_paged_engine_matches_flat(mode):
    """Greedy paged == flat on the mixed wave (refreeze, CoW divergence,
    hits), and again on a second wave that admits on a warm trie."""
    _, tcfg, _, tparams = _params(mode)
    prompts = _shared_wave(tcfg.vocab)
    kw = dict(slots=2, max_tokens=128, bs=16, prefill_chunk=32, device="cpu")
    flat = ContinuousEngine(tparams, tcfg, **kw)
    eng = ContinuousEngine(tparams, tcfg, paged=True, **kw)
    out_flat, _ = _drive(flat, prompts, SamplingParams)
    out_paged, res = _drive(eng, prompts, SamplingParams)
    assert out_paged == out_flat
    assert len(eng._trie) > 0
    out2, res2 = _drive(eng, prompts, SamplingParams)
    assert out2 == _drive(flat, prompts, SamplingParams)[0]
    # the warm wave skipped the shared prefill outright
    assert min(o.metrics.ttft for o in res2.values()) < \
        min(o.metrics.ttft for o in res.values())


def test_paged_int8_engine_matches_reference():
    """The port's paged engine on int8 weights emits the reference paged
    engine's greedy tokens (f32 model, same packed bytes), cold and on a
    warm trie, with the same trie, free pages and refcounts.

    Why these weights (seed 2): per-row int8 activation quantisation turns
    a one-ulp f32 difference that sits at a rounding boundary into a
    one-step change of an int8 activation, about 1e-2 on that linear's
    output.  The two frameworks' f32 sums (attention, norms) differ by
    ulps, so token identity across frameworks holds exactly on inputs where
    no activation lands within an ulp of a boundary.  On seed 0 such a flip
    happens in layer 0's MLP (input 1.5e-7 apart, output 1.6e-2 apart); on
    seed 2 none does over both waves.  Within the port, where the
    arithmetic is the same, paged equals flat on every seed
    (:func:`test_paged_engine_matches_flat`)."""
    jcfg, tcfg, jparams, tparams = _params("int8", seed=2)
    prompts = _shared_wave(tcfg.vocab)
    kw = dict(slots=2, max_tokens=128, bs=16, prefill_chunk=32, paged=True)
    ref = JaxEngine(jparams, jcfg, **kw)
    eng = ContinuousEngine(tparams, tcfg, device="cpu", **kw)
    for _ in range(2):
        want, _ = _drive(ref, prompts, JaxParams)
        got, _ = _drive(eng, prompts, SamplingParams)
        assert got == want
        assert len(eng._trie) == len(ref._trie)
        assert eng._alloc.free_blocks() == ref._alloc.free_blocks()
    np.testing.assert_array_equal(eng.state["refcount"].numpy(),
                                  np.asarray(ref.state["refcount"]))


def test_paged_prefix_hit_skips_prefill_and_shares_pages():
    _, tcfg, _, tparams = _params("bf16")
    rng = np.random.default_rng(1)
    shared = rng.integers(0, tcfg.vocab, (64,)).tolist()
    p0 = shared + rng.integers(0, tcfg.vocab, (6,)).tolist()
    p1 = shared + rng.integers(0, tcfg.vocab, (3,)).tolist()
    kw = dict(slots=2, max_tokens=128, bs=16, prefill_chunk=32, device="cpu")
    eng = ContinuousEngine(tparams, tcfg, paged=True, **kw)
    eng.submit(p0, SamplingParams(max_new_tokens=4))
    eng.run()
    assert len(eng._trie) == 4                   # 64 tokens / bs, chunked
    cached = eng._alloc.free_blocks()

    rid = eng.submit(p1, SamplingParams(max_new_tokens=4))
    eng.step()                                   # admission tick
    slot, req = next((s, r) for s, r in eng.scheduler.active.items()
                     if r.rid == rid)
    # the 64-token hit is the prefill: one tick covers hit + the 3-token
    # suffix chunk
    assert req.prefill_done == len(p1)
    row = eng._blocks[slot]
    assert len(row) >= 4
    rc = eng.state["refcount"]
    assert all(int(rc[b]) == 1 for b in row[:4])  # revived from the LRU
    assert eng.state["table"][slot, :4].tolist() == row[:4]
    assert eng._alloc.free_blocks() < cached
    out = eng.run()
    assert out[rid].finish_reason == "length"
    flat = ContinuousEngine(tparams, tcfg, **kw)
    fid = flat.submit(p1, SamplingParams(max_new_tokens=4))
    assert flat.run()[fid].token_ids == out[rid].token_ids


def test_paged_plain_decode_keeps_only_the_weights():
    """The plain matmuls keep each CPU weight's decompressed copy; the
    paged attention's prefix, gathered afresh at every call, is not kept:
    once the weights are in, further decode ticks add no entry."""
    from repro_torch.core import sparse_format
    _, tcfg, _, tparams = _params("bf16")
    eng = ContinuousEngine(tparams, tcfg, paged=True, slots=2, max_tokens=128,
                           bs=16, prefill_chunk=32, device="cpu")
    prompt = np.random.default_rng(3).integers(0, tcfg.vocab, (40,)).tolist()
    eng.submit(prompt, SamplingParams(max_new_tokens=12))
    for _ in range(4):                      # the prefill and first ticks
        eng.step()
    kept = len(sparse_format._DENSE)
    assert 0 < kept < sparse_format._DENSE_MAX
    for _ in range(6):
        eng.step()
    assert len(sparse_format._DENSE) == kept


def test_paged_eviction_invalidates_trie_and_stays_correct():
    """A tiny arena: new traffic must LRU-evict the cached shared prefix
    (trie entries drop), and a later request with that prefix re-prefills
    and still matches the flat engine."""
    _, tcfg, _, tparams = _params("bf16")
    rng = np.random.default_rng(2)
    shared = rng.integers(0, tcfg.vocab, (48,)).tolist()
    p0 = shared + rng.integers(0, tcfg.vocab, (4,)).tolist()
    other = [rng.integers(0, tcfg.vocab, (52,)).tolist() for _ in range(2)]
    kw = dict(slots=1, max_tokens=64, bs=16, prefill_chunk=16, device="cpu")
    eng = ContinuousEngine(tparams, tcfg, paged=True, phys_blocks=7, **kw)
    sp = SamplingParams(max_new_tokens=8)
    r0 = eng.submit(p0, sp)
    first = eng.run()[r0].token_ids
    trie0 = len(eng._trie)
    assert trie0 > 0
    for p in other:                               # churn: forces eviction
        eng.submit(p, sp)
        eng.run()
    assert eng._alloc.evictions > 0
    assert len(eng._trie) < trie0 + 2 * 3
    r2 = eng.submit(p0, sp)
    assert eng.run()[r2].token_ids == first
    flat = ContinuousEngine(tparams, tcfg, **kw)
    fid = flat.submit(p0, sp)
    assert flat.run()[fid].token_ids == first


def test_paged_admission_defers_when_the_arena_is_short():
    """A request whose worst-case page demand exceeds what the arena can
    promise waits in the queue (backing off) until a release frees pages,
    then runs to the same tokens."""
    _, tcfg, _, tparams = _params("bf16")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab, (40,)).tolist() for _ in range(2)]
    kw = dict(slots=2, max_tokens=64, bs=16, prefill_chunk=16, device="cpu")
    clock = [0.0]
    eng = ContinuousEngine(tparams, tcfg, paged=True, phys_blocks=4,
                           clock=lambda: clock[0], **kw)
    sp = SamplingParams(max_new_tokens=8)        # 48 tokens: 3 pages each
    rids = [eng.submit(p, sp) for p in prompts]
    eng.step()
    assert len(eng.scheduler.active) == 1 and len(eng.scheduler.queue) == 1
    assert eng.scheduler.queue[0].next_admit > 0
    while not eng.scheduler.done():
        clock[0] += 1.0
        eng.step()
    out = eng.scheduler.finished
    flat = ContinuousEngine(tparams, tcfg, **kw)
    want = [flat.submit(p, sp) for p in prompts]
    res = flat.run()
    assert [tuple(out[r].generated) for r in rids] == [res[r].token_ids
                                                        for r in want]
