"""The port's blocked attention (``models/flash.py``) against the
reference's on the same numpy inputs at f32: both schedules, causal and
not, ``bq != bkv``, outputs within 1e-6 and gradients against ``jax.vjp``
within 1e-5; the ``ValueError`` of sequences that are not multiples of
their blocks; ``attn_apply`` past ``cfg.full_attn_max`` (set to 32 in
both configs, so the case stays cheap) and a one-shot ``Engine`` prefill
past it, logits and cache, against the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import NULL_CTX
from repro.models import attention as jattn
from repro.models import flash as jflash
from repro.serving import Engine as JaxEngine

from repro_torch.models import attention as tattn
from repro_torch.models import flash as tflash
from repro_torch.models import lm
from repro_torch.serving import Engine

from torch_parity import as_np, rand, reference_model

LIMIT = 32                 # full_attn_max in both configs


def _grads(fn, args, cot):
    """``(out, grads)`` of ``fn(*args)`` against the cotangent ``cot``."""
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    out.backward(torch.tensor(cot))
    return out.detach(), [t.grad for t in ts]


# (impl, causal, S, Skv, bq, bkv)
CASES = [("masked", True, 64, 64, 32, 16),
         ("triangular", True, 64, 64, 32, 16),
         ("triangular", True, 64, 64, 16, 32),
         ("masked", False, 32, 48, 16, 16),
         ("triangular", False, 32, 48, 32, 16)]


@pytest.mark.parametrize("impl,causal,s,skv,bq,bkv", CASES)
def test_blocked_attention_matches_the_reference(impl, causal, s, skv, bq,
                                                 bkv):
    q, k, v = (rand((2, 2, n, 16), seed) for n, seed in
               ((s, 0), (skv, 1), (skv, 2)))
    cot = rand((2, 2, s, 16), 3)
    sm = 0.25

    def ref(q, k, v):
        return jflash.blocked_attention(q, k, v, sm, causal=causal, bq=bq,
                                        bkv=bkv, impl=impl)
    want, vjp = jax.jit(lambda *a: jax.vjp(ref, *a))(q, k, v)
    want_g = vjp(jnp.asarray(cot))
    got, got_g = _grads(lambda *a: tflash.blocked_attention(
        *a, sm, causal=causal, bq=bq, bkv=bkv, impl=impl), (q, k, v), cot)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=0, atol=1e-6)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(as_np(g), as_np(w), rtol=0, atol=1e-5)
    if causal and s == skv:
        # the blocked schedules are the unblocked attention
        full = tflash.full_attention(*map(torch.tensor, (q, k, v)), sm)
        np.testing.assert_allclose(as_np(got), as_np(full), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("s,skv,bq,bkv", [(48, 48, 32, 16),
                                          (32, 48, 16, 32)])
def test_blocked_attention_refuses_ragged_blocks(s, skv, bq, bkv):
    q, k = torch.zeros((1, 1, s, 8)), torch.zeros((1, 1, skv, 8))
    with pytest.raises(ValueError, match="not multiples of blocks"):
        tflash.blocked_attention(q, k, k, 1.0, causal=False, bq=bq, bkv=bkv)
    with pytest.raises(ValueError, match="not multiples of blocks"):
        jflash.blocked_attention(jnp.asarray(q.numpy()),
                                 jnp.asarray(k.numpy()),
                                 jnp.asarray(k.numpy()), 1.0, causal=False,
                                 bq=bq, bkv=bkv)


@pytest.mark.parametrize("impl", ["masked", "triangular"])
def test_attn_apply_past_the_limit_matches_the_reference(impl):
    """A 64-token sequence past a 32-token ``full_attn_max`` (the
    blocks clamp to 64: one block of each; the second case's
    ``return_kv`` K/V un-repeated, as the cache wants them)."""
    jcfg, tcfg, jp, tp = reference_model("qwen3-0.6b",
                                         full_attn_max=LIMIT)
    x = rand((2, 2 * LIMIT, jcfg.d_model), 5)
    pos = np.arange(2 * LIMIT)
    jmix = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["l0"]["mixer"])
    tmix = lm._layer(tp["blocks"], 0)["l0"]["mixer"]
    want, (wk, wv) = jax.jit(lambda p, x: jattn.attn_apply(
        p, x, jcfg, NULL_CTX, jnp.asarray(pos), attn_impl=impl,
        return_kv=True))(jmix, x)
    got, (gk, gv) = tattn.attn_apply(tmix, torch.tensor(x), tcfg,
                                     torch.tensor(pos), attn_impl=impl,
                                     return_kv=True)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=0, atol=1e-5)
    assert gk.shape == (2, tcfg.n_kv, 2 * LIMIT, tcfg.hd)
    np.testing.assert_allclose(as_np(gk), as_np(wk), rtol=0, atol=1e-5)
    np.testing.assert_allclose(as_np(gv), as_np(wv), rtol=0, atol=1e-5)


def test_one_shot_prefill_past_the_limit_matches_the_reference():
    """The one-shot ``Engine.prefill`` of 2 x 64 tokens past the 32-token
    limit (the reference's path there is the blocked attention too):
    last-token logits within 1e-4 and the dense cache's K/V within 1e-5 of
    the reference ``Engine``'s, at f32."""
    jcfg, tcfg, jp, tp = reference_model("qwen3-0.6b",
                                         full_attn_max=LIMIT)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 2 * LIMIT))
    jcache, jlogits = JaxEngine(jp, jcfg, kv_mode="dense").prefill(
        {"tokens": jnp.asarray(toks, jnp.int32)})
    tcache, tlogits = Engine(tp, tcfg, kv_mode="dense",
                             device="cpu").prefill({"tokens": toks})
    np.testing.assert_allclose(as_np(tlogits), as_np(jlogits), rtol=0,
                               atol=1e-4)
    jkv, tkv = jcache["layers"]["l0"]["kv"], tcache["layers"]["l0"]["kv"]
    n = 2 * LIMIT
    for a, b in ((jkv.k, tkv.k), (jkv.v, tkv.v)):
        np.testing.assert_allclose(as_np(b)[..., :n, :], as_np(a)[..., :n, :],
                                   rtol=0, atol=1e-5)
    assert int(tcache["pos"]) == n
