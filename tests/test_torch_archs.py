"""Every registered config in the port against the reference, at the
reduced sizes: every config equal to the reference's field by field (and
the registry's shapes, ids and paper model); the full configs'
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
shapes.

The recurrent, hybrid and encoder-decoder families (RWKV-6, Jamba,
SeamlessM4T): their full-width specs' tree, shapes and dtypes (meta, no
allocation); ``convert_concrete`` packing the leaves the reference packs,
bit for bit; the one-shot cache's leaves (states, cross K/V) shaped as
the reference's; the one-shot ``Engine``'s greedy tokens identical to the
JAX ``Engine``'s at f32 across a refreeze, sparse and dense KV; the
pooled path refusing each with the reference's ``ValueError``; the
launcher falling back to the one-shot engine for each."""
import contextlib
import dataclasses
import io
import re

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

from torch_parity import reference_model, sparse_params, to_numpy

ONE_SHOT = ["rwkv6-7b", "jamba-1.5-large-398b", "seamless-m4t-medium"]
PORTED = ["qwen3-0.6b", "llama3-8b", "llama3.2-3b", "phi3-mini-3.8b",
          "deepseek-67b", "internvl2-1b", "phi3.5-moe-42b-a6.6b",
          "llama4-scout-17b-a16e", *ONE_SHOT]
NEW = PORTED[1:]
MOE = ["phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"]


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
    assert set(PORTED) == set(jconfigs._MODULES) == set(tconfigs._MODULES)
    assert {tconfigs.get_config(n).family for n in ONE_SHOT} == \
        {"ssm", "hybrid", "encdec"}


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
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.normal(size=(b, s + 4, cfg.d_model)) \
            .astype(np.float32)
    if cfg.frontend:
        batch["frontend_embeds"] = (rng.normal(
            size=(b, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)
    return batch


@pytest.mark.parametrize("name", NEW)
def test_prefill_logits_match_the_reference(name):
    """f32, the reference's dense weights bridged: every position's logits
    within 1e-5 of the logit range, the collected K/V (within 1e-5; a
    recurrent layer's states within 1e-5 of their range) and the length
    (the frontend tokens counted) the reference's."""
    jcfg, tcfg, jparams, params = reference_model(name)
    batch = _batch(tcfg, 2, 20, seed=3)
    jh, jcol = jax.jit(lambda p, b: jlm.forward_prefill(
        p, b, jcfg, NULL_CTX))(jparams, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    want = np.asarray(jlm.logits_fn(jparams, jh, jcfg, NULL_CTX))
    th, tcol = lm.forward_prefill(
        params, {k: torch.as_tensor(v) for k, v in batch.items()}, tcfg)
    got = lm.logits_fn(params, th, tcfg).numpy()
    assert got.shape == want.shape == \
        (2, 20 + (tcfg.frontend_tokens if tcfg.frontend else 0), tcfg.vocab)
    assert np.abs(got - want).max() <= 1e-5 * (want.max() - want.min())
    assert tcol["len"] == jcol["len"]
    got_l0, want_l0 = tcol["layers"]["l0"], jcol["layers"]["l0"]
    if "k" in want_l0:
        np.testing.assert_allclose(got_l0["k"].numpy(),
                                   np.asarray(want_l0["k"]), atol=1e-5)
    else:       # a recurrent layer's states, within 1e-5 of their range
        assert set(got_l0["state"]) == set(want_l0["state"])
        for key, want_st in want_l0["state"].items():
            b = np.asarray(want_st)
            assert np.abs(got_l0["state"][key].numpy() - b).max() <= \
                1e-5 * (b.max() - b.min()), key


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


def _tree(tree):
    """Nested dict -> {path: (shape, dtype name)} of its leaves."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}" if path else k)
        else:
            out[path] = (tuple(t.shape), np.dtype(t.dtype).name
                         if not isinstance(t.dtype, torch.dtype)
                         else str(t.dtype).split(".")[-1])
    walk(tree, "")
    return out


@pytest.mark.parametrize("name", ONE_SHOT)
def test_full_width_specs_tree_and_dtypes_equal_the_reference(name):
    """RWKV-6-7B (the RWKV block: ``ln1``, ``tmix``, ``ln2``), Jamba (the
    Mamba mixer beside the attention, MoE every other layer; a period of
    8) and SeamlessM4T (``ln_cross`` / ``cross`` in each decoder layer,
    the ``encoder`` / ``enc_norm`` subtrees) at full width: the same
    paths, shapes and dtypes, built on meta tensors (nothing allocated)."""
    j, t = jconfigs.get_config(name), tconfigs.get_config(name)
    assert _tree(lm.model_specs(t)) == _tree(jlm.model_specs(j))
    meta = lm.init_cache(t, 2, 256, abstract=True)
    assert all(a.device.type == "meta"
               for a in meta["layers"]["l0"].get("state", {}).values())
    if name == "jamba-1.5-large-398b":
        assert lm.period_len(t) == 8
        assert lm._kinds(t)[4] == ("attn", "mlp") and \
            lm._kinds(t)[1] == ("mamba", "moe")
        assert lm.model_specs(t)["blocks"]["l0"]["mixer"]["w_bcdt"].shape \
            == (9, 16384, 512 + 32)


@pytest.mark.parametrize("name", ONE_SHOT)
def test_convert_concrete_packs_the_reference_leaves(name):
    """At the reduced sizes, bf16: the port's ``convert_concrete`` of the
    reference's dense draw packs exactly the leaves the reference's
    packs (the encoder's and the cross attention's linears, RWKV's eight,
    Mamba's ``w_in`` / ``w_out``; not ``w_bcdt``, ``conv_w``, ``dt_w``,
    ``a_log``, ``decay_*``, ``mu_*``, ``bonus_u``), their bitmaps and
    values bit-equal, every other leaf equal."""
    from repro.distributed.convert_plan import convert_concrete as jconvert
    from repro_torch.core.convert import convert_concrete
    from repro_torch.core.sparse_format import BlockSparseWeight
    jcfg, tcfg, jdense, _ = reference_model(name, "bfloat16")
    assert jcfg == jconfigs.get_config(name).reduced()
    want = to_numpy(jax.jit(lambda p: jconvert(
        p, jlm.model_specs(jcfg), jcfg, NULL_CTX))(jdense))
    got = convert_concrete(bridge.params_from_numpy(to_numpy(jdense), tcfg,
                                                    "cpu"),
                           lm.model_specs(tcfg), tcfg, device="cpu")
    packed = []

    def walk(g, w, path):
        if isinstance(g, BlockSparseWeight):
            packed.append(path.rsplit("/", 1)[-1])
            assert set(w) == {"bitmap", "values", "scale", "shape", "block",
                              "packed4"}, path
            np.testing.assert_array_equal(g.bitmap.numpy(),
                                          w["bitmap"].view(np.int32))
            np.testing.assert_array_equal(
                g.values.view(torch.int16).numpy(),
                w["values"].view(np.int16))
        elif isinstance(g, dict):
            assert set(g) == set(w), path
            for k in g:
                walk(g[k], w[k], f"{path}/{k}")
        else:
            assert not isinstance(w, dict), path
            np.testing.assert_array_equal(
                g.float().numpy(), np.asarray(w, np.float32))
    walk(got, want, "")
    want_keys = {"rwkv6-7b": {"w_r", "w_k", "w_v", "w_g", "w_o", "w_ck",
                              "w_cv", "w_cr"},
                 "jamba-1.5-large-398b": {"w_in", "w_out", "wq", "wk", "wv",
                                          "wo", "w_gate", "w_up", "w_down"},
                 "seamless-m4t-medium": {"wq", "wk", "wv", "wo", "w_gate",
                                         "w_up", "w_down"}}[name]
    assert set(packed) == want_keys
    if name == "seamless-m4t-medium":     # decoder self, cross, MLP; encoder
        assert len(packed) == 11 + 7


@pytest.mark.parametrize("name", ONE_SHOT)
def test_one_shot_cache_equals_the_reference_shapes(name):
    """``init_cache`` (abstract, both KV modes): the recurrent states, the
    attention caches and an encoder-decoder's ``cross`` entry with the
    reference's shapes; a real cache is zeros."""
    j, t = jconfigs.get_config(name).reduced(), \
        tconfigs.get_config(name).reduced()
    for mode in ("sparse", "dense"):
        ours = lm.init_cache(t, 2, 64, mode=mode, abstract=True)
        theirs = jlm.init_cache(j, 2, 64, mode=mode, abstract=True)
        flat = jax.tree_util.tree_leaves_with_path(theirs)
        want = sorted(tuple(x.shape) for _, x in flat)
        got = []

        def walk(tree):
            if isinstance(tree, dict):
                for v in tree.values():
                    walk(v)
            elif torch.is_tensor(tree):
                got.append(tuple(tree.shape))
            else:                            # a sparse or dense KV cache
                lm._cache_map(tree, lambda t: got.append(tuple(t.shape)))
        walk(ours)
        assert sorted(got) == want, mode
        assert set(ours) == set(theirs)
    real = lm.init_cache(t, 2, 64, device="cpu")
    assert int(real["pos"]) == 0


@pytest.mark.parametrize("name,kv_mode,n_new", [
    ("rwkv6-7b", "sparse", 20),
    ("jamba-1.5-large-398b", "sparse", 20),
    ("jamba-1.5-large-398b", "dense", 17),
    ("seamless-m4t-medium", "sparse", 20),
    ("seamless-m4t-medium", "dense", 17),
])
def test_one_shot_tokens_equal_the_reference(name, kv_mode, n_new):
    """f32, the reference's dense weights bridged, a 16-token tail: greedy
    tokens from two 16-token prompts (an encoder-decoder over 20 seeded
    frames) identical to the JAX one-shot ``Engine``'s; the sparse cache
    refreezes once on the way (20 new tokens), the dense one fills (17:
    the prompt and ``kv_tail`` tokens).  RWKV-6 holds no KV cache, so it
    runs in one mode."""
    jcfg, tcfg, jparams, tparams = reference_model(name, kv_tail=16)
    batch = _batch(tcfg, 2, 16, seed=8)
    want, _ = JaxOneShot(jparams, jcfg, kv_mode=kv_mode).generate(
        {k: jnp.asarray(v) for k, v in batch.items()},
        JaxParams(max_new_tokens=n_new))
    got, cache = Engine(tparams, tcfg, kv_mode=kv_mode, device="cpu") \
        .generate(batch, SamplingParams(max_new_tokens=n_new))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(cache["pos"]) == 16 + n_new - 1


@pytest.mark.parametrize("name", ONE_SHOT)
def test_pooled_path_refuses_the_family(name):
    """``_attn_kinds`` raises the reference's ``ValueError`` (word for
    word), so the pool and ``ContinuousEngine`` refuse each family as the
    reference's do."""
    _, tcfg = _pair(name)
    jcfg = jconfigs.get_config(name).reduced()
    with pytest.raises(ValueError) as want:
        jlm._attn_kinds(jcfg)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        lm._attn_kinds(tcfg)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        ContinuousEngine(lm.init_params(tcfg, 0, "cpu"), tcfg, slots=2,
                         max_tokens=64, device="cpu")


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


FALLBACK = ["--batch", "2"]


@pytest.mark.parametrize("arch,extra,expect,packed", [
    ("llama3-8b", STREAM, "[serve] stream: 2 requests", 7),
    ("internvl2-1b", FALLBACK, "[serve] one-shot: 3 tokens x 2", 7),
    ("phi3.5-moe-42b-a6.6b", STREAM, "[serve] stream: 2 requests", 4),
    ("rwkv6-7b", FALLBACK, "[serve] one-shot: 3 tokens x 2", 8),
    ("jamba-1.5-large-398b", FALLBACK, "[serve] one-shot: 3 tokens x 2", 9),
    ("seamless-m4t-medium", FALLBACK, "[serve] one-shot: 3 tokens x 2", 18),
], ids=["llama3-8b-stream", "internvl2-1b-fallback", "phi3.5-moe-stream",
        "rwkv6-7b-fallback", "jamba-fallback", "seamless-fallback"])
def test_launcher_serves_the_new_archs(arch, extra, expect, packed):
    """Stream mode where the pooled path takes the config; otherwise the
    fallback to the one-shot engine (zero frontend embeddings; zero
    ``src_embeds`` of the prompt's length for the encoder-decoder)."""
    out = _serve(["--arch", arch, "--reduced", "--device", "cpu",
                  "--prompt-len", "24", "--steps", "3", *extra])
    assert f"[serve] sparse-converted {packed} weights" in out
    assert expect in out
    if extra is FALLBACK:
        assert "falling back to the one-shot engine" in out


SMEM_LIMIT = 232448         # bytes of shared memory a Hopper block may use


# the sparse linears of a layer (every position of a period) by config
N_LINEARS = {"rwkv6-7b": 8, "seamless-m4t-medium": 11,
             "jamba-1.5-large-398b": 7 * 2 + 4 * 3 + 4}


@pytest.mark.parametrize("name", ["llama3-8b", "phi3-mini-3.8b",
                                  "internvl2-1b", "llama3.2-3b", *MOE,
                                  *ONE_SHOT])
def test_kernel_plans_fit_the_new_shapes(name):
    """The launch plans at the full configs' shapes (no card, no tensor):
    every linear's gemv, sparse matmul and int plans fit a block's shared
    memory (the gemv's two blocks an SM), their splits cover the padded K
    (Llama-3-8B's ``w_down``: 224 splits); the head's launch takes the rows
    that fit at K = d and tiles the whole vocabulary (SeamlessM4T's
    256206 rows: 2002 tiles, the last ragged); the dense kernel's plan fits
    at every dense linear of the config (Jamba's Mamba ``w_bcdt``, K =
    16384, and K = 14336 for Llama-3-8B's ``w_down`` under ``--dense``: x
    streamed in K panels, 64 rows a launch); the attention's plan at the
    config's head dim fits, with one 16-row tile per 16 query rows at QG =
    G (decode) and 5 G (a verify panel; Scout's G is 5).  An MoE's linears
    are those ``convert_concrete`` packs (its attention, Scout's shared
    expert); a period's every position counts (Jamba: 7 Mamba mixers of
    two sparse linears, 4 dense MLPs of three, one attention of four)."""
    from repro_torch.distributed.convert_plan import _is_sparsifiable
    from repro_torch.core.sparse_format import DEFAULT_BLOCK
    from repro_torch.kernels import dense_matmul as dm
    from repro_torch.kernels.sparse_attention import attention_plan
    from repro_torch.kernels.sparse_gemv import gemv_plan
    from repro_torch.kernels.sparse_matmul import launch_plan
    from repro_torch.kernels.sparse_matmul_int8 import int_launch_plan
    from repro_torch.models import module as mod
    cfg = tconfigs.get_config(name)
    bk, bn = DEFAULT_BLOCK
    linears, dense = [], []
    blocks = lm.model_specs(cfg)["blocks"]
    mod.map_with_path(
        lambda p, s: (linears if _is_sparsifiable(p, s) else dense).append(
            (p.rsplit("/", 1)[-1], s)) if len(s.shape) == 3 else None,
        blocks)
    assert len(linears) == N_LINEARS.get(
        name, 4 if cfg.n_experts and not cfg.shared_expert else 7)
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
    # every dense product the config can run through the dense kernel:
    # its head, its linears under --dense, Mamba's w_bcdt
    ks = {cfg.d_model} | {s.shape[-2] for _, s in linears + dense
                          if _ in ("w_bcdt",)} | \
        {s.shape[-2] for _, s in linears}
    for k in ks:
        rows = dm.launch_rows(k)
        assert rows >= 16 and rows % 16 == 0
        for m in (1, 4, rows):
            plan = dm.dense_plan(m, k, cfg.vocab)
            assert plan.smem <= SMEM_LIMIT and \
                plan.tiles * dm.TILE >= cfg.vocab
            assert plan.xstream == (k > 4672)
    if name in ("llama3-8b", "jamba-1.5-large-398b"):
        assert max(ks) == {"llama3-8b": 14336,
                           "jamba-1.5-large-398b": 24576}[name]
        assert 16384 in ks or name == "llama3-8b"
    if name == "seamless-m4t-medium":
        assert dm.dense_plan(4, 1024, cfg.vocab).tiles == 2002
    if not cfg.n_kv:                       # RWKV: no attention
        return
    pool = CachePool.build(dataclasses.replace(
        cfg, family="dense", frontend="", n_experts=0), 4, 1024, bs=128,
        device="cpu")
    plan = attention_plan(7, cfg.kv_tail, 128, cfg.hd, pool.cap_k,
                          pool.cap_v, 2)
    g = cfg.padded_heads // cfg.n_kv
    assert plan.smem <= SMEM_LIMIT and plan.row_tile == 16
    assert [plan.tiles(q * g) for q in (1, 5)] == \
        [-(-g // 16), -(-5 * g // 16)]
