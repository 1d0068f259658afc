"""The port's encoder-decoder (SeamlessM4T) against the reference, at the
reduced config (2 encoder and 2 decoder layers), f32, on the reference's
weights carried over by the bridge and inputs from a numpy seed:

* ``attn_apply`` with ``memory=`` (cross attention: K/V from the memory,
  no RoPE on either side, no mask) and with ``causal=False`` / ``True``
  over the query alone (RoPE, a mask only when causal);
* ``cross_attn_decode`` over the encoder's dense K/V;
* ``forward_prefill`` with ``src_embeds``: the logits, the decoder's K/V
  and the cross K/V stacked over the layers; the encoder's own mask
  follows the reference's (causal: its stack derives the mask from a
  memory it does not have);
* ``forward_decode`` one step from the one-shot engine's cache (sparse
  and dense KV): the logits and the cache position.

Every check is within 1e-5 of the reference output's range.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import NULL_CTX
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.serving import Engine as JaxOneShot

from repro_torch.models import attention, lm
from repro_torch.serving import Engine

from torch_parity import as_np, reference_model

NAME = "seamless-m4t-medium"
TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    """(jax cfg, port cfg, jax params, port params), drawn once per
    process (``torch_parity.reference_model``)."""
    jcfg, tcfg, jp, tp = reference_model(NAME)
    assert tcfg.family == "encdec" and tcfg.enc_layers == 2
    return jcfg, tcfg, jp, tp


def _r(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, what, tol=TOL):
    g, w = as_np(got), as_np(want)
    assert g.shape == w.shape, what
    err = np.abs(g - w).max() / max(w.max() - w.min(), 1e-12)
    assert err <= tol, f"{what}: {err:.3e} of the range > {tol}"


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


@pytest.mark.parametrize("mode", ["memory", "causal", "bidirectional"])
def test_attn_apply_equals_the_reference(model, mode):
    """Layer 0's cross-attention weights over ``x [2, 9, d]``: with a
    memory ``[2, 14, d]`` (the K/V returned are the memory's), or over
    ``x`` alone with ``causal=True`` / ``False``."""
    jcfg, tcfg, jp, tp = model
    jw = _layer0(jp["blocks"]["l0"]["cross"])
    tw = _layer0(tp["blocks"]["l0"]["cross"])
    x, mem = _r((2, 9, tcfg.d_model), 1), _r((2, 14, tcfg.d_model), 2)
    pos = np.arange(9)
    kw = ({"memory": mem} if mode == "memory"
          else {"causal": mode == "causal"})
    want, (jk, jv) = jattn.attn_apply(
        jw, jnp.asarray(x), jcfg, NULL_CTX, jnp.asarray(pos),
        return_kv=True, **{k: jnp.asarray(v) if k == "memory" else v
                           for k, v in kw.items()})
    got, (tk, tv) = attention.attn_apply(
        tw, torch.from_numpy(x), tcfg, torch.from_numpy(pos),
        return_kv=True, **{k: torch.from_numpy(v) if k == "memory" else v
                           for k, v in kw.items()})
    _close(got, want, "out")
    _close(tk, jk, "k")
    _close(tv, jv, "v")
    assert tk.shape[2] == (14 if mode == "memory" else 9)


def test_cross_attn_decode_equals_the_reference(model):
    jcfg, tcfg, jp, tp = model
    jw = _layer0(jp["blocks"]["l0"]["cross"])
    tw = _layer0(tp["blocks"]["l0"]["cross"])
    x = _r((2, tcfg.d_model), 3)
    k, v = (_r((2, tcfg.n_kv, 14, tcfg.hd), s) for s in (4, 5))
    want = jattn.cross_attn_decode(jw, jnp.asarray(x), jnp.asarray(k),
                                   jnp.asarray(v), jcfg)
    got = attention.cross_attn_decode(tw, torch.from_numpy(x),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), tcfg)
    _close(got, want, "cross attention")


def _batch(cfg, seed, s=18, sm=24):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (2, s)).astype(np.int32),
            "src_embeds": rng.normal(size=(2, sm, cfg.d_model)).astype(
                np.float32)}


def test_forward_prefill_with_src_embeds_equals_the_reference(model):
    """The encoder over 24 seeded frames, the decoder over 18 tokens: every
    position's logits, the decoder's self-attention K/V and the cross K/V
    of the encoder's output ``[P, B, Hkv, 24, hd]``."""
    jcfg, tcfg, jp, tp = model
    batch = _batch(tcfg, 6)
    jh, jcol = jax.jit(lambda p, b: jlm.forward_prefill(
        p, b, jcfg, NULL_CTX))(jp, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    th, tcol = lm.forward_prefill(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    _close(lm.logits_fn(tp, th, tcfg), jlm.logits_fn(jp, jh, jcfg, NULL_CTX),
           "logits")
    assert tcol["len"] == jcol["len"] == 18
    for key in ("k", "v"):
        _close(tcol["layers"]["l0"][key], jcol["layers"]["l0"][key], key)
        _close(tcol["cross"]["l0"][key], jcol["cross"]["l0"][key],
               f"cross {key}")
    assert tuple(tcol["cross"]["l0"]["k"].shape) == \
        (tcfg.n_layers, 2, tcfg.n_kv, 24, tcfg.hd)


@pytest.mark.parametrize("kv_mode", ["sparse", "dense"])
def test_forward_decode_equals_the_reference(model, kv_mode):
    """Each engine's prefill cache (KV sparsity 30 / 50 %, or the dense
    cache) and one ``forward_decode`` of the same next tokens: the logits
    within 1e-5 of the range, the position advanced, the cross K/V
    untouched."""
    jcfg, tcfg, jp, tp = model
    batch = _batch(tcfg, 7, s=16)
    jeng = JaxOneShot(jp, jcfg, kv_mode=kv_mode)
    jcache, jlog = jeng.prefill({k: jnp.asarray(v)
                                 for k, v in batch.items()})
    eng = Engine(tp, tcfg, kv_mode=kv_mode, device="cpu")
    cache, log = eng.prefill(batch)
    _close(log, jlog, "prefill logits")
    nxt = np.asarray(jlog).argmax(-1)[:, None].astype(np.int32)
    want, jcache = jax.jit(lambda p, c, t: jlm.forward_decode(
        p, c, t, jcfg, NULL_CTX))(jp, jcache, jnp.asarray(nxt))
    cross = {k: v.clone() for k, v in cache["cross"].items()}
    got, cache = lm.forward_decode(eng.params, cache, torch.from_numpy(nxt),
                                   tcfg)
    _close(got, want, "decode logits")
    assert int(cache["pos"]) == int(jcache["pos"]) == 17
    assert all(torch.equal(cross[k], cache["cross"][k]) for k in cross)
