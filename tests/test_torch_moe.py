"""The MoE family in the port against the reference, at the reduced sizes
(4 experts, 2 layers): reduced Phi-3.5-MoE (top-2) and Llama-4-Scout
(top-1 and a shared expert through the sparse linears).

``moe_apply`` on the same seeded rows and the bridged layer-0 weights
equals the JAX ``moe_apply`` (no mesh, so ``moe_local``): at f32 within
1e-5 of the output range, at bf16 within 2e-2 of it, at the configs'
capacity factor and at 0.25, where the JAX routing drops tokens; the
routing indices are the reference's at every row whose top-k margin is
at least 1e-6.  The device capacity of a padded chunk is the host rule at
every length; a 128-wide chunk with 100 valid tokens gives the logits and
the pool state of the reference's 100-token chunk at a capacity factor
where the capacity of 100 tokens drops tokens the capacity of 128 would
keep.  At f32, greedy tokens of the port's engines equal the JAX
engines': Phi-3.5-MoE flat across a refreeze, paged, speculative (k = 2)
and one-shot, and Scout flat.  The layer reads no tensor value on the
host, and the mesh paths raise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import NULL_CTX
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Engine as JaxOneShot
from repro.serving import SamplingParams as JaxParams
from repro.serving import SpecConfig as JaxSpec
from repro.serving.cache_pool import CachePool as JaxPool

from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.core.convert import convert_to_sparse
from repro_torch.models import lm, moe
from repro_torch.serving import (ContinuousEngine, Engine, SamplingParams,
                                 SpecConfig)

from torch_parity import as_np, rand, sparse_params, to_numpy

PHI, SCOUT = "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"
ROWS = 64                     # rows of the moe_apply cases
MARGIN = 1e-6                 # a top-k margin below this may flip
TOL = {"float32": 1e-5, "bfloat16": 2e-2}     # of the output range
BS = 16


def _pair(name, dtype="float32", **kw):
    kw = dict(compute_dtype=dtype, param_dtype=dtype, n_layers=2, **kw)
    return (dataclasses.replace(jconfigs.get_config(name).reduced(), **kw),
            dataclasses.replace(tconfigs.get_config(name).reduced(), **kw))


@pytest.fixture(scope="module")
def models():
    """Per arch, at f32: the reference's sparse-converted weights (the
    expert stacks and the router dense) and the port's bridged copy."""
    out = {}
    for name in (PHI, SCOUT):
        jcfg, tcfg = _pair(name, kv_tail=16)
        out[name] = (jcfg, tcfg, *sparse_params(jcfg, tcfg, seed=7))
    return out


EXPERTS = ("w_gate", "w_up", "w_down")


def _ffn0(jparams, tcfg, dtype="float32"):
    """Layer 0's FFN: (reference tree, port tree), the expert stacks cast
    to ``dtype`` (the router stays f32; the shared expert's packed values
    are bf16 at any model dtype, as the reference packs them)."""
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["l0"]["ffn"])
    jp = {k: v.astype(jnp.dtype(dtype)) if k in EXPERTS else v
          for k, v in jp.items()}
    return jp, bridge.params_from_numpy(to_numpy(jp), tcfg, "cpu")


def _loads(jp, x, cfg):
    """The reference's routing of ``x [T, d]``: (top-k ids [T, k], top-k
    margins [T], the largest per-slot expert load)."""
    probs = jax.nn.softmax(jnp.dot(jnp.asarray(x, jnp.float32),
                                   jp["router"]), axis=-1)
    top_p, top_i = jax.lax.top_k(probs, cfg.top_k + 1)
    srt = np.asarray(top_p)
    gaps = np.diff(-srt, axis=1)[:, :cfg.top_k]
    ids = np.asarray(top_i)[:, :cfg.top_k]
    load = max(np.bincount(ids[:, s], minlength=cfg.n_experts).max()
               for s in range(cfg.top_k))
    return ids, gaps.min(1), load


@pytest.mark.parametrize("cf", [1.25, 0.25], ids=["cf1.25", "cf0.25-drops"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", [PHI, SCOUT], ids=["phi3.5-moe", "scout"])
def test_moe_apply_matches_the_reference(models, name, dtype, cf):
    """``[2, 32, d]`` seeded rows through layer 0's MoE: the output within
    TOL of the reference's output range, the routing the reference's but
    at near-ties; at capacity factor 0.25 the reference drops tokens."""
    _, _, jparams, _ = models[name]
    jcfg, tcfg = _pair(name, dtype, capacity_factor=cf)
    jp, tp = _ffn0(jparams, tcfg, dtype)
    x = rand((2, ROWS // 2, tcfg.d_model), seed=11)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = jax.jit(lambda p, v: jmoe.moe_apply(p, v, jcfg, None))(jp, jx)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tcfg.cdtype)
    got = moe.moe_apply(tp, tx, tcfg)
    assert got.dtype == tcfg.cdtype and got.shape == tx.shape
    want = as_np(want)
    err = np.abs(as_np(got) - want).max()
    assert err <= TOL[dtype] * (want.max() - want.min()), err
    ids, gap, load = _loads(jp, np.asarray(jx.astype(jnp.float32)).reshape(
        ROWS, -1), tcfg)
    _, got_ids = moe.route(tp, tx.reshape(ROWS, -1), tcfg.top_k)
    clear = gap >= MARGIN
    assert clear.sum() >= ROWS - 2
    np.testing.assert_array_equal(got_ids.numpy()[clear], ids[clear])
    c = moe._capacity(ROWS, tcfg.top_k, tcfg.n_experts, cf)
    assert (load > c) == (cf < 1), (load, c)


@pytest.mark.parametrize("cf", [1.25, 0.25, 0.3, 1.0])
def test_device_capacity_is_the_host_rule(cf):
    n = torch.arange(0, 700)
    for k, e in ((1, 4), (2, 4), (1, 16), (2, 16)):
        want = [moe._capacity(int(t), k, e, cf) for t in n]
        assert moe._capacity_of(n, k, e, cf).tolist() == want


def test_expert_w_unpacks_a_packed_expert_stack(models):
    """``convert_to_sparse`` folds an ``[E, K, N]`` stack into one
    ``[E*K, N]`` weight; ``_expert_w`` gives back the pruned experts."""
    _, tcfg, _, tparams = models[PHI]
    w = tparams["blocks"]["l0"]["ffn"]["w_gate"][0]
    sw = convert_to_sparse({"w_gate": w}, block=(64, 64),
                           mode="keep")["w_gate"]
    got = moe._expert_w(sw, tcfg.n_experts)
    assert got.shape == w.shape
    kept = got != 0
    assert torch.equal(got[kept], w[kept])
    assert 0.4 < kept.float().mean() < 0.6
    assert moe._expert_w(w, tcfg.n_experts) is w


def test_padded_chunk_with_drops_matches_the_reference(models, monkeypatch):
    """Reduced Phi-3.5-MoE at capacity factor 0.3: a chunk padded to the
    128-token width class with 100 valid tokens against the reference's
    100-token chunk on a fresh flat pool, slot 1: the last token's logits
    and every state leaf within 1e-4 (integers exactly).  From the JAX
    routing of the first MoE layer's input: the capacity of 100 tokens (16)
    drops tokens that the width class's capacity (24) would keep."""
    jcfg, tcfg, jparams, tparams = models[PHI]
    jcfg = dataclasses.replace(jcfg, capacity_factor=0.3)
    tcfg = dataclasses.replace(tcfg, capacity_factor=0.3)
    w, n = 128, 100
    c_n, c_w = (moe._capacity(t, 2, 4, 0.3) for t in (n, w))
    assert (c_n, c_w) == (16, 24)
    toks = np.random.default_rng(2).integers(0, tcfg.vocab, (1, n))
    jpool = JaxPool.build(jcfg, slots=2, max_tokens=256, bs=BS)
    jst = jpool.init_state()
    ref_logits, ref = jax.jit(lambda p, s, t: jlm.forward_prefill_chunk(
        p, s, t, jnp.int32(1), jcfg, NULL_CTX, BS))(
            jparams, jst, jnp.asarray(toks, jnp.int32))
    seen = []
    local = moe.moe_local
    monkeypatch.setattr(moe, "moe_local", lambda p, x, cfg, length=None: (
        seen.append(x) or local(p, x, cfg, length)))
    padded = np.zeros((1, w), np.int64)
    padded[0, :n] = toks[0]
    got_logits, got = lm.forward_prefill_chunk(
        tparams, bridge.state_from_numpy(to_numpy(jst), "cpu"),
        torch.from_numpy(padded), torch.tensor([1]), tcfg, BS,
        length=torch.tensor([n]))
    np.testing.assert_allclose(as_np(got_logits), as_np(ref_logits),
                               rtol=1e-4, atol=1e-4)
    _assert_state(ref, got)
    jp, _ = _ffn0(jparams, tcfg)
    _, _, load = _loads(jp, seen[0][:n].numpy(), tcfg)
    assert c_n < load, (c_n, load)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_state(ref, got):
    ref, got = _flat(ref), _flat(got)
    assert ref.keys() == got.keys()
    for k, a in ref.items():
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(got[k].numpy(), a, err_msg=k)
        else:
            np.testing.assert_allclose(as_np(got[k]), a.astype(np.float64),
                                       rtol=1e-4, atol=1e-4, err_msg=k)


def _generate(engine, params_cls, toks, n_new):
    return np.asarray(engine.generate_batch(
        toks, params_cls(max_new_tokens=n_new))).tolist()


@pytest.mark.parametrize("name,kw", [
    (PHI, {}),
    (PHI, {"paged": True}),
    (PHI, {"spec": 2}),
    (SCOUT, {}),
], ids=["phi3.5-moe-flat", "phi3.5-moe-paged", "phi3.5-moe-spec2",
        "scout-flat"])
def test_continuous_engine_tokens_equal_the_reference(models, name, kw):
    """f32, the bridged weights, KV sparsity 30% / 50%, a 16-token tail: 20
    greedy tokens from two 21-token prompts (each slot crosses a refreeze)
    identical to the JAX ``ContinuousEngine``'s, flat, paged or with a
    2-token draft window against the JAX spec engine."""
    jcfg, tcfg, jparams, tparams = models[name]
    k = kw.pop("spec", 0)
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (2, 21))
    common = dict(slots=2, max_tokens=80, bs=BS, prefill_chunk=16, **kw)
    want = _generate(JaxEngine(jparams, jcfg, spec=JaxSpec(k=k) if k else None,
                               **common),
                     JaxParams, jnp.asarray(toks, jnp.int32), 20)
    got = _generate(ContinuousEngine(tparams, tcfg,
                                     spec=SpecConfig(k=k) if k else None,
                                     device="cpu", **common),
                    SamplingParams, toks, 20)
    assert got == want


def test_one_shot_engine_tokens_equal_the_reference(models):
    """Reduced Phi-3.5-MoE, f32: the one-shot ``Engine``'s 8 greedy tokens
    from a [2, 32] batch (the prefill routes all 64 rows at once, the
    decode the batch's 2) are the JAX ``Engine``'s."""
    jcfg, tcfg, jparams, tparams = models[PHI]
    toks = np.random.default_rng(5).integers(0, tcfg.vocab, (2, 32))
    want, _ = JaxOneShot(jparams, jcfg).generate(
        {"tokens": jnp.asarray(toks, jnp.int32)}, JaxParams(max_new_tokens=8))
    got, _ = Engine(tparams, tcfg, device="cpu").generate(
        {"tokens": toks}, SamplingParams(max_new_tokens=8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


HOST_READS = ("item", "tolist", "nonzero", "cpu", "numpy", "__bool__")


def test_moe_reads_no_tensor_value_on_the_host(models, monkeypatch):
    """The layer as a captured entry runs it (a padded chunk's device
    length, and a decode panel's rows) with every host read of a tensor
    value raising."""
    _, tcfg, jparams, _ = models[SCOUT]
    _, tp = _ffn0(jparams, tcfg)
    x = torch.from_numpy(rand((1, 48, tcfg.d_model), seed=3))
    length = torch.tensor([37])
    for name in HOST_READS:
        def read(self, *a, _name=name, **k):
            raise AssertionError(f"host read .{_name}() in the MoE layer")
        monkeypatch.setattr(torch.Tensor, name, read)
    moe.moe_apply(tp, x, tcfg, length=length)
    moe.moe_apply(tp, x.reshape(48, 1, -1), tcfg)


def test_mesh_paths_raise_by_item(models):
    """On a mesh of one rank (every axis of size 1) ``moe_apply`` is the
    unsharded layer bit for bit, with ``ep_moe`` too: the expert-parallel
    path declines (None) where the data axes do not split the experts, as
    the reference's does.  The ranks' paths are held in
    ``tests/test_torch_train_mesh.py``."""
    _, tcfg, jparams, _ = models[PHI]
    _, tp = _ffn0(jparams, tcfg)
    from repro_torch.distributed import ShardCtx, default_rules
    mesh = type("Mesh", (), {"shape": {"data": 1, "model": 1}})()
    ep_cfg = dataclasses.replace(tcfg, ep_moe=True)
    ctx = ShardCtx(mesh, default_rules(False, ep_cfg))
    x = torch.from_numpy(rand((2, 8, tcfg.d_model), seed=4))
    want = moe.moe_apply(tp, x, tcfg)
    assert torch.equal(moe.moe_apply(tp, x, ep_cfg, ctx), want)
    assert moe.moe_apply_ep(tp, x, ep_cfg, ctx) is None
