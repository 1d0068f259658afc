"""The dense and MoE configs and the VLM in the port against the
reference, at the reduced sizes: every registered config equal to the
reference's field by field (and the registry's shapes, ids and paper
model), the unported families refused by name; the full configs'
parameter shapes equal (the untied head, the padded heads of Llama-3.2-3B,
the 4-D expert stacks, no allocation); ``convert_concrete`` packs an MoE's
attention and shared expert and leaves its router and expert stacks
dense; each new architecture's prefill logits at f32 within 1e-5 of the
logit range of the JAX ``forward_prefill`` (InternVL2 after its frontend
embeddings);
greedy tokens of the port's ``ContinuousEngine`` identical to the JAX
engine's for reduced Llama-3-8B (untied head, no ``qk_norm``) and an MHA
Phi-3-mini at D = 96 across a refreeze; the one-shot ``Engine`` on reduced
InternVL2 with seeded frontend embeddings identical to the JAX
``Engine``; a frontend config refused by the pooled path; the launcher
serving Llama-3-8B and Phi-3.5-MoE in stream mode and InternVL2 through
the one-shot fallback; the kernels' launch plans at every full config's
shapes."""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import NULL_CTX
from repro.models import lm as jlm
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Engine as JaxOneShot
from repro.serving import SamplingParams as JaxParams

from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import lm
from repro_torch.serving import (CachePool, ContinuousEngine, Engine,
                                 SamplingParams)

from torch_parity import sparse_params, to_numpy

PORTED = ["qwen3-0.6b", "llama3-8b", "llama3.2-3b", "phi3-mini-3.8b",
          "deepseek-67b", "internvl2-1b", "phi3.5-moe-42b-a6.6b",
          "llama4-scout-17b-a16e"]
NEW = PORTED[1:]
MOE = ["phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"]
NOT_PORTED = {"seamless-m4t-medium": "encdec", "rwkv6-7b": "ssm",
              "jamba-1.5-large-398b": "hybrid"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", PORTED)
def test_config_equals_the_reference(name):
    j, t = jconfigs.get_config(name), tconfigs.get_config(name)
    for a, b in ((j, t), (j.reduced(), t.reduced())):
        assert _fields(b) == _fields(a)
        assert (b.hd, b.padded_heads, b.d_inner) == \
            (a.hd, a.padded_heads, a.d_inner)
        assert str(b.pdtype).split(".")[-1] == str(a.pdtype)
        assert tconfigs.applicable_shapes(b) == jconfigs.applicable_shapes(a)


def test_registry_equals_the_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.PAPER_ARCH == jconfigs.PAPER_ARCH == "llama3-8b"
    assert {k: dataclasses.astuple(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()}
    assert set(PORTED) | set(NOT_PORTED) == set(jconfigs._MODULES)


@pytest.mark.parametrize("name", sorted(NOT_PORTED))
def test_unported_family_raises_by_name(name):
    family = NOT_PORTED[name]
    assert jconfigs.get_config(name).family == family
    with pytest.raises(KeyError, match=f"{family} family"):
        tconfigs.get_config(name)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


@pytest.mark.parametrize("name", NEW)
def test_full_width_param_shapes_equal_the_reference(name):
    """The specs at full width (nothing allocated): the untied head
    ``[d, V]``, Llama-3.2-3B's 24 heads padded to 32, MHA, D = 64 / 96."""
    j, t = jconfigs.get_config(name), tconfigs.get_config(name)
    assert _shapes(lm.model_specs(t)) == _shapes(jlm.model_specs(j))
    embed = lm.model_specs(t)["embed"]
    assert ("lm_head" in embed) == (not t.tie_embeddings)
    if name == "llama3.2-3b":
        assert t.padded_heads == 32 and t.n_heads == 24
        assert lm.model_specs(t)["blocks"]["l0"]["mixer"]["wq"].shape == \
            (28, 3072, 32 * 128)
    if name in MOE:
        ffn = lm.model_specs(t)["blocks"]["l0"]["ffn"]
        assert ffn["w_gate"].shape == (t.n_layers, 16, t.d_model, t.d_ff)
        assert ffn["router"].shape == (t.n_layers, t.d_model, 16)
        assert ("shared" in ffn) == t.shared_expert


@pytest.mark.parametrize("name", MOE)
def test_convert_concrete_leaves_the_expert_stacks_dense(name):
    """At the reduced sizes: the attention (and Scout's shared expert)
    packed per layer, the f32 router and the ``[L, E, K, N]`` expert
    stacks left dense and bit-equal, as the reference's
    ``_is_sparsifiable`` leaves them."""
    from repro_torch.core.convert import convert_concrete
    from repro_torch.core.sparse_format import BlockSparseWeight
    cfg = tconfigs.get_config(name).reduced()
    specs = lm.model_specs(cfg)
    params = lm.init_params(cfg, seed=0, device="cpu")
    out = convert_concrete(params, specs, cfg, device="cpu")
    ffn, got = params["blocks"]["l0"]["ffn"], out["blocks"]["l0"]["ffn"]
    for key in ("router", "w_gate", "w_up", "w_down"):
        assert torch.is_tensor(got[key]) and torch.equal(got[key], ffn[key])
    assert got["router"].dtype == torch.float32
    assert got["w_gate"].dim() == 4
    assert all(isinstance(w, BlockSparseWeight)
               for w in out["blocks"]["l0"]["mixer"].values())
    assert ("shared" in got) == cfg.shared_expert
    if cfg.shared_expert:
        assert all(isinstance(w, BlockSparseWeight)
                   for w in got["shared"].values())


def _pair(name, **kw):
    kw = dict(compute_dtype="float32", param_dtype="float32", **kw)
    return (dataclasses.replace(jconfigs.get_config(name).reduced(), **kw),
            dataclasses.replace(tconfigs.get_config(name).reduced(), **kw))


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend:
        batch["frontend_embeds"] = (rng.normal(
            size=(b, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)
    return batch


@pytest.mark.parametrize("name", NEW)
def test_prefill_logits_match_the_reference(name):
    """f32, the reference's dense weights bridged: every position's logits
    within 1e-5 of the logit range, the collected K/V and the length (the
    frontend tokens counted) the reference's."""
    jcfg, tcfg = _pair(name)
    jparams, params = _dense_params(jcfg, tcfg, seed=3)
    batch = _batch(tcfg, 2, 20, seed=3)
    jh, jcol = jlm.forward_prefill(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
        NULL_CTX)
    want = np.asarray(jlm.logits_fn(jparams, jh, jcfg, NULL_CTX))
    th, tcol = lm.forward_prefill(
        params, {k: torch.as_tensor(v) for k, v in batch.items()}, tcfg)
    got = lm.logits_fn(params, th, tcfg).numpy()
    assert got.shape == want.shape == \
        (2, 20 + (tcfg.frontend_tokens if tcfg.frontend else 0), tcfg.vocab)
    assert np.abs(got - want).max() <= 1e-5 * (want.max() - want.min())
    assert tcol["len"] == jcol["len"]
    np.testing.assert_allclose(tcol["layers"]["l0"]["k"].numpy(),
                               np.asarray(jcol["layers"]["l0"]["k"]),
                               atol=1e-5)


def _generate(engine, params_cls, toks, n_new):
    return np.asarray(engine.generate_batch(
        toks, params_cls(max_new_tokens=n_new))).tolist()


def _dense_params(jcfg, tcfg, seed):
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, bridge.params_from_numpy(to_numpy(jparams), tcfg, "cpu")


@pytest.mark.parametrize("name,kw,weights", [
    ("llama3-8b", {}, sparse_params),
    ("phi3-mini-3.8b", {"n_kv": 4, "head_dim": 96}, _dense_params),
], ids=["llama3-8b-sparse", "phi3-mini-mha-d96-dense"])
def test_continuous_engine_tokens_equal_the_reference(name, kw, weights):
    """f32, the bridged weights (sparse for Llama-3-8B, dense for the MHA
    Phi-3-mini, whose point is the attention), KV sparsity 30% / 50%, a
    16-token tail: 20 greedy tokens from two 21-token prompts (each slot
    crosses a refreeze) identical to the JAX ``ContinuousEngine``'s."""
    jcfg, tcfg = _pair(name, kv_tail=16, **kw)
    assert not tcfg.qk_norm and not tcfg.tie_embeddings
    assert tcfg.padded_heads // tcfg.n_kv == (1 if kw else 2)
    jparams, tparams = weights(jcfg, tcfg, seed=4)
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (2, 21))
    want = _generate(JaxEngine(jparams, jcfg, slots=2, max_tokens=80, bs=16,
                               prefill_chunk=16),
                     JaxParams, jnp.asarray(toks, jnp.int32), 20)
    got = _generate(ContinuousEngine(tparams, tcfg, slots=2, max_tokens=80,
                                     bs=16, prefill_chunk=16, device="cpu"),
                    SamplingParams, toks, 20)
    assert got == want


def test_one_shot_vlm_tokens_equal_the_reference():
    """Reduced InternVL2 (G = 2 after the reduction, the stub frontend's 8
    seeded embeddings before 24 prompt tokens), f32, the bridged dense
    weights: the one-shot ``Engine``'s greedy tokens are the JAX
    ``Engine``'s, and the cache position counts the frontend."""
    jcfg, tcfg = _pair("internvl2-1b")
    jparams, tparams = _dense_params(jcfg, tcfg, seed=5)
    batch = _batch(tcfg, 2, 24, seed=5)
    want, jcache = JaxOneShot(jparams, jcfg).generate(
        {k: jnp.asarray(v) for k, v in batch.items()},
        JaxParams(max_new_tokens=6))
    got, cache = Engine(tparams, tcfg, device="cpu").generate(
        batch, SamplingParams(max_new_tokens=6))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(cache["pos"]) == int(jcache["pos"]) == \
        tcfg.frontend_tokens + 24 + 5


def test_frontend_config_takes_the_one_shot_path_only():
    _, tcfg = _pair("internvl2-1b")
    with pytest.raises(ValueError, match="frontend"):
        lm._attn_kinds(tcfg)
    with pytest.raises(ValueError, match="frontend"):
        CachePool.build(tcfg, 2, 64, device="cpu")
    assert lm._kinds(tcfg) == [("attn", "mlp")]


def _serve(args):
    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert serve.main(args) == 0
    return buf.getvalue()


STREAM = ["--requests", "2", "--slots", "2", "--prefill-chunk", "16"]


@pytest.mark.parametrize("arch,extra,expect,packed", [
    ("llama3-8b", STREAM, "[serve] stream: 2 requests", 7),
    ("internvl2-1b", ["--batch", "2"], "[serve] one-shot: 3 tokens x 2", 7),
    ("phi3.5-moe-42b-a6.6b", STREAM, "[serve] stream: 2 requests", 4),
], ids=["llama3-8b-stream", "internvl2-1b-fallback", "phi3.5-moe-stream"])
def test_launcher_serves_the_new_archs(arch, extra, expect, packed):
    out = _serve(["--arch", arch, "--reduced", "--device", "cpu",
                  "--prompt-len", "24", "--steps", "3", *extra])
    assert f"[serve] sparse-converted {packed} weights" in out
    assert expect in out
    if arch == "internvl2-1b":
        assert "falling back to the one-shot engine" in out


SMEM_LIMIT = 232448         # bytes of shared memory a Hopper block may use


@pytest.mark.parametrize("name", ["llama3-8b", "phi3-mini-3.8b",
                                  "internvl2-1b", "llama3.2-3b", *MOE])
def test_kernel_plans_fit_the_new_shapes(name):
    """The launch plans at the full configs' shapes (no card, no tensor):
    every linear's gemv, sparse matmul and int plans fit a block's shared
    memory (the gemv's two blocks an SM), their splits cover the padded K
    (Llama-3-8B's ``w_down``: 224 splits); the head's launch takes the rows
    that fit at K = d and tiles the whole vocabulary; the attention's plan
    at the config's head dim fits, with one 16-row tile per 16 query rows
    at QG = G (decode) and 5 G (a verify panel; Scout's G is 5).  An MoE's
    linears are those ``convert_concrete`` packs (its attention, Scout's
    shared expert)."""
    from repro_torch.core.convert import _is_sparsifiable
    from repro_torch.core.sparse_format import DEFAULT_BLOCK
    from repro_torch.kernels import dense_matmul as dm
    from repro_torch.kernels.sparse_attention import attention_plan
    from repro_torch.kernels.sparse_gemv import gemv_plan
    from repro_torch.kernels.sparse_matmul import launch_plan
    from repro_torch.kernels.sparse_matmul_int8 import int_launch_plan
    from repro_torch.models import module as mod
    cfg = tconfigs.get_config(name)
    bk, bn = DEFAULT_BLOCK
    linears = []
    mod.map_with_path(lambda p, s: linears.append((p.rsplit("/", 1)[-1], s))
                      if _is_sparsifiable(p, s) else None,
                      lm.model_specs(cfg)["blocks"]["l0"])
    assert len(linears) == (4 if cfg.n_experts and not cfg.shared_expert
                            else 7)
    for key, spec in linears:
        k, n = spec.shape[-2:]
        kp, np_ = -(-k // bk) * bk, -(-n // bn) * bn
        g = gemv_plan(kp, np_, DEFAULT_BLOCK)
        assert len(g.splits) == kp // g.rows_per_split, key
        assert 2 * g.smem <= SMEM_LIMIT
        for x_bytes in (2, 4):
            assert launch_plan(kp, np_, DEFAULT_BLOCK,
                               x_bytes).smem <= SMEM_LIMIT
        for int4 in (False, True):
            assert int_launch_plan(kp, np_, DEFAULT_BLOCK,
                                   int4).smem <= SMEM_LIMIT
        if name == "llama3-8b" and key == "w_down":
            assert len(g.splits) == 224
    rows = dm.launch_rows(cfg.d_model)
    assert rows >= 16 and rows % 16 == 0
    head = dm.dense_plan(rows, cfg.d_model, cfg.vocab)
    assert head.smem <= SMEM_LIMIT and head.tiles * dm.TILE >= cfg.vocab
    pool = CachePool.build(dataclasses.replace(cfg, frontend=""), 4, 1024,
                           bs=128, device="cpu")
    plan = attention_plan(7, cfg.kv_tail, 128, cfg.hd, pool.cap_k,
                          pool.cap_v, 2)
    g = cfg.padded_heads // cfg.n_kv
    assert plan.smem <= SMEM_LIMIT and plan.row_tile == 16
    assert [plan.tiles(q * g) for q in (1, 5)] == \
        [-(-g // 16), -(-5 * g // 16)]
