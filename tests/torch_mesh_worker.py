"""Rank body of ``tests/test_torch_mesh.py``: four gloo CPU ranks serve the
reference worker's setup (``tests/workers/sharded_serving_worker.py``)
through the port's mesh.  Imports torch and the port only: no JAX and
nothing of the reference package; the reference's params and inputs come
from a file the parent wrote.  Each rank returns what it saw, and the
parent holds it against the reference's unsharded engine."""
import dataclasses
import pickle

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.sparse_format import BlockSparseWeight
from repro_torch.core.sparse_kv import SparseKVCache
from repro_torch.distributed import ShardCtx, default_rules, local_shard
from repro_torch.distributed import serving_sharding
from repro_torch.distributed.cp_attention import sparse_decode_attention_cp
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.serving import (CachePool, ContinuousEngine, Engine,
                                 SamplingParams, SpecConfig)

# the reference worker's engine geometry
ENGINE = dict(slots=4, max_tokens=96, bs=16, device="cpu", graphs=False)


def waves(eng, toks):
    """The reference worker's lockstep wave and staggered wave."""
    out1 = eng.generate_batch(toks, SamplingParams(max_new_tokens=24)
                              ).tolist()
    rids = [eng.submit(toks[i % 4][:7 + 3 * i],
                       SamplingParams(max_new_tokens=20 - 2 * i))
            for i in range(6)]
    res = eng.run()
    return out1, [list(res[r].token_ids) for r in rids]


def paged_run(eng, prompts, new_tokens):
    rids = [eng.submit(p, SamplingParams(max_new_tokens=new_tokens))
            for p in prompts]
    res = eng.run()
    return [list(res[r].token_ids) for r in rids]


def _cut(tree, spec_tree, mesh):
    if isinstance(tree, dict):
        return {k: _cut(v, spec_tree[k], mesh) for k, v in tree.items()}
    return local_shard(tree, spec_tree, mesh)


def pool_roundtrip(cfg, mesh):
    """append -> rollback -> re-append -> refreeze on this rank's shard of
    the pool against the same transitions on the full pool (the reference
    worker's ``run_pool``), at the engine's nonzero KV sparsity: every leaf
    of the shard must equal its block of the full result bit for bit."""
    cfg = dataclasses.replace(cfg, kv_k_sparsity=0.3, kv_v_sparsity=0.5)
    ctx = serving_sharding.serving_ctx(mesh, cfg)
    full = CachePool.build(cfg, slots=4, max_tokens=64, bs=16, device="cpu")
    axes = full.state_axes()
    mine = dataclasses.replace(
        full, slots=len(serving_sharding.local_slots(ctx, 4)),
        kv_heads=len(serving_sharding.local_heads(ctx, cfg.n_kv)))
    rng = np.random.default_rng(3)
    t = full.tail
    shape = (cfg.n_layers // lm.period_len(cfg), 4, cfg.n_kv, t, cfg.hd)
    panels = {f"l{j}": {"k": torch.from_numpy(rng.normal(size=shape)).float(),
                        "v": torch.from_numpy(rng.normal(size=shape)).float()}
              for j in range(lm.period_len(cfg))}
    pan_spec = ctx.spec((None, "slots", "kv_heads", None, None), shape)
    vec_spec = serving_sharding.vec_sharding(ctx, 4)

    def transitions(pool, state, pan, vec, pctx):
        st = pool.append_many(state, pan, vec(torch.tensor([t, t, t, t])))
        st = pool.rollback(st, vec(torch.tensor([5, 0, 2, t])))
        st = pool.append_many(st, pan, vec(torch.tensor([5, 0, 2, t])))
        return pool.refreeze(st, ctx=pctx)

    plain = transitions(full, full.init_state(), panels, lambda v: v, None)
    sharded = transitions(
        mine, serving_sharding.shard_state(ctx, full.init_state(), axes),
        {k: {kk: local_shard(a, pan_spec, mesh) for kk, a in d.items()}
         for k, d in panels.items()},
        lambda v: local_shard(v, vec_spec, mesh).contiguous(), ctx)
    want = _cut(plain, serving_sharding.state_shardings(ctx, plain, axes),
                mesh)
    bad = []

    def cmp(a, b, path):
        if isinstance(a, dict):
            for k in a:
                cmp(a[k], b[k], f"{path}/{k}")
        elif not torch.equal(a, b):
            bad.append(path)
    cmp(sharded, want, "")
    return {"roundtrip_match": not bad, "mismatched": bad,
            "prefix_blocks": plain["prefix_blocks"].tolist(),
            "tail_len": plain["tail_len"].tolist()}


def cp_cases(mesh, cases):
    """Context-parallel decode over the model axis on the reference's
    frozen caches: each case's output beside the reference oracle's."""
    out = []
    for case in cases:
        sw = lambda d: BlockSparseWeight(
            bitmap=bridge.tensor_from_numpy(d["bitmap"], "cpu"),
            values=bridge.tensor_from_numpy(d["values"], "cpu"), scale=None,
            shape=tuple(d["shape"]), block=tuple(d["block"]))
        cache = SparseKVCache(
            sw(case["k_sp"]), sw(case["v_sp"]),
            torch.from_numpy(case["k_tail"]), torch.from_numpy(case["v_tail"]),
            torch.tensor(case["tail_len"], dtype=torch.int32))
        ctx = ShardCtx(mesh, default_rules(False))
        prefix = (None if case["prefix_len"] is None
                  else torch.tensor(case["prefix_len"], dtype=torch.int32))
        o = sparse_decode_attention_cp(torch.from_numpy(case["q"]), cache,
                                       case["hkv"], case["sm"], ctx, prefix)
        out.append(float(np.abs(o.double().numpy() - case["want"]).max()))
    return out


def oneshot_cp(cfg, params, mesh, toks):
    """The one-shot Engine with ``cp_decode`` and a mesh ctx against the
    same engine without one (greedy tokens)."""
    cfg = dataclasses.replace(cfg, cp_decode=True)
    batch = {"tokens": toks}
    sp = SamplingParams(max_new_tokens=6)
    alone = Engine(params, cfg, device="cpu").generate(batch, sp)[0]
    ctx = ShardCtx(mesh, default_rules(False, cfg))
    cp = Engine(params, cfg, device="cpu", ctx=ctx).generate(batch, sp)[0]
    return {"match": torch.equal(alone, cp), "tokens": cp.tolist()}


def refusals(params, cfg, mesh):
    """The refusals a mesh keeps: graphs under gloo, checkify, snapshots,
    ``ctx=`` with ``mesh=``."""
    got = {}

    def expect(name, fn):
        try:
            fn()
            got[name] = "no error"
        except ValueError as e:
            got[name] = str(e)
    kw = {k: v for k, v in ENGINE.items() if k != "graphs"}
    expect("graphs", lambda: ContinuousEngine(params, cfg, mesh=mesh, **kw))
    expect("checkify", lambda: ContinuousEngine(
        params, cfg, mesh=mesh, checkify=True, graphs=False, **kw))
    expect("ctx", lambda: ContinuousEngine(
        params, cfg, mesh=mesh, ctx=ShardCtx(), graphs=False, **kw))
    eng = ContinuousEngine(params, cfg, mesh=mesh, paged=True,
                           prefill_chunk=16, **ENGINE)
    expect("snapshot", lambda: eng.save_snapshot("unused"))
    return got


def run(rank, world, path):
    torch.set_num_threads(1)
    with open(path, "rb") as f:
        inp = pickle.load(f)
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              **inp["cfg"])
    params = bridge.params_from_numpy(inp["params"], cfg, "cpu")
    toks = np.asarray(inp["toks"])
    rec = {"engine": {}}
    for label, shape in (("dp4", (4, 1)), ("dp2tp2", (2, 2))):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        eng = ContinuousEngine(params, cfg, mesh=mesh, **ENGINE)
        rec["engine"][label] = {"waves": waves(eng, toks),
                                "rows": list(eng._rows),
                                "kv_heads": eng.pool.kv_heads}
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    eng = ContinuousEngine(params, cfg, mesh=mesh, spec=SpecConfig(k=3),
                           **ENGINE)
    rec["spec"] = {"waves": waves(eng, toks),
                   "accepted": int(eng.spec_hist[1:].sum())}
    rec["pool"] = pool_roundtrip(cfg, mesh)
    eng = ContinuousEngine(params, cfg, mesh=mesh, paged=True,
                           prefill_chunk=16, **ENGINE)
    rec["paged"] = {"tokens": paged_run(eng, inp["paged_prompts"],
                                        inp["paged_new"]),
                    "trie": len(eng._trie),
                    "refcount": eng.state["refcount"].tolist(),
                    "arena": float(sum(
                        leaf.double().abs().sum()
                        for layer in eng.pool.arena_leaves(eng.state).values()
                        for leaf in layer.values()))}
    rec["cp"] = cp_cases(mesh, inp["cp_cases"])
    rec["oneshot_cp"] = oneshot_cp(cfg, params, mesh,
                                   torch.from_numpy(inp["oneshot_toks"]))
    rec["refusals"] = refusals(params, cfg, mesh)
    return rec
