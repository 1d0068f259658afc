"""The prefix-only partial attention and the two-pass decode around it.

* The plain partial against ``sparse_decode_attention_pallas`` in interpret
  mode, ``o`` and ``lse``, over per-slot valid-block counts {0, 1, partial,
  all}, G in {1, 2, 4, 72} (72 * D = 2304: past the first CUDA design's
  QG * D <= 2048), bs in {16, 128}, KV sparsity 0/0 and 0.3/0.5 and
  f32 and bf16 inputs, with poisoned blocks past each slot's count:
  atol = rtol = 1e-5 at f32 inputs, 1e-4 at bf16 inputs (both sides
  expand to f32 and sum in another order).
* The tail-less branch of ``ops.sparse_decode_attention`` against the
  reference's, with exact zeros for an empty prefix.
* The twins of the reference's XLA partial helpers (``gqa_partial_ref``,
  ``_merge_attn``, ``_len_valid``).
* A reduced f32 engine decoding through the two-pass dispatch (prefix
  partial + grouped tail partial + lse merge) emits the fused engine's
  greedy tokens and the reference engine's, across refreezes.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.sparse_kv import freeze_chunk_blocks, pooled_view
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.sparse_attention import sparse_decode_attention_pallas
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import SamplingParams as JaxParams

from repro_torch import bridge
from repro_torch.core.sparse_kv import pooled_view as tview
from repro_torch.kernels import ops as tops
from repro_torch.kernels.sparse_attention import (
    NEG_INF, gqa_partial, len_valid, merge_attn,
    sparse_decode_attention_partial, sparse_decode_attention_partial_plain)
from repro_torch.serving import ContinuousEngine, SamplingParams

from torch_parity import configs, rand, sparse_params

B, HKV, D, SB = 4, 2, 32, 4
# per-slot valid blocks: empty, one, part, all
N_BLOCKS = np.asarray([0, 1, 2, SB], np.int32)


def _case(g, bs, ks, vs, dtype, seed=0):
    """Kernel-layout operands (numpy) in ``dtype``; blocks past each slot's
    valid count hold large values, so a masking leak breaks parity."""
    k = rand((B, HKV, SB * bs, D), seed)
    v = rand((B, HKV, SB * bs, D), seed + 1)
    for b, nb in enumerate(N_BLOCKS):
        k[b, :, nb * bs:] = 50.0
        v[b, :, nb * bs:] = 50.0
    cap = bs * D
    arrays = [np.asarray(a) for a in freeze_chunk_blocks(
        jnp.asarray(k, dtype), jnp.asarray(v, dtype), ks, vs, bs, cap, cap)]
    q = np.asarray(jnp.asarray(rand((B, HKV, g, D), seed + 2), dtype))
    return q, arrays


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ks,vs", [(0.0, 0.0), (0.3, 0.5)],
                         ids=["dense", "sparse"])
@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 72])
def test_partial_plain_matches_pallas(g, bs, ks, vs, dtype):
    q, arrays = _case(g, bs, ks, vs, jnp.dtype(dtype))
    sm = 1.0 / D ** 0.5
    o_ref, lse_ref = sparse_decode_attention_pallas(
        jnp.asarray(q), *(jnp.asarray(a) for a in arrays), bs=bs,
        sm_scale=sm, interpret=True, n_blocks=jnp.asarray(N_BLOCKS))
    t = [bridge.tensor_from_numpy(a, "cpu") for a in (q, *arrays)]
    o, lse = sparse_decode_attention_partial(
        *t, bs, sm, torch.from_numpy(N_BLOCKS))
    tol = 1e-5 if dtype == "float32" else 1e-4
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=tol,
                               atol=tol)
    # the empty slot: o exactly 0, lse at the -1e30 floor, in both
    assert not o[0].any() and not np.asarray(o_ref)[0].any()
    assert (lse[0] <= -1e29).all() and (np.asarray(lse_ref)[0] <= -1e29).all()


def test_partial_wrapper_takes_the_plain_version_on_the_cpu():
    q, arrays = _case(2, 16, 0.3, 0.5, jnp.float32)
    t = [bridge.tensor_from_numpy(a, "cpu") for a in (q, *arrays)]
    nb = torch.from_numpy(N_BLOCKS)
    before = sparse_decode_attention_partial.launches
    got = sparse_decode_attention_partial(*t, 16, 0.2, nb)
    want = sparse_decode_attention_partial_plain(*t, 16, 0.2, nb)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sparse_decode_attention_partial.launches == before
    # None means every block is valid
    full = sparse_decode_attention_partial(*t, 16, 0.2)
    every = sparse_decode_attention_partial(
        *t, 16, 0.2, torch.full((B,), SB, dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(full, every))
    assert NEG_INF == -1e30


def _pooled(bs=16, seed=0):
    """A pooled prefix view for both packages."""
    k = rand((B, HKV, SB * bs, D), seed)
    v = rand((B, HKV, SB * bs, D), seed + 1)
    cap = bs * D
    jk = freeze_chunk_blocks(jnp.asarray(k), jnp.asarray(v), 0.3, 0.5, bs,
                             cap, cap)
    tk = [bridge.tensor_from_numpy(np.asarray(a), "cpu") for a in jk]
    return ((pooled_view(jk[0], jk[1], bs, D), pooled_view(jk[2], jk[3], bs,
                                                           D)),
            (tview(tk[0], tk[1], bs, D), tview(tk[2], tk[3], bs, D)))


@pytest.mark.parametrize("qshape,prefix_len", [
    pytest.param((B, HKV * 2, D), [0, 64, 32, 16], id="per_slot"),
    pytest.param((B, HKV * 2, D), None, id="all_valid"),
    pytest.param((B, HKV * 4, D), 32, id="scalar_g4"),
    pytest.param((B, 1, HKV * 2, D), [16, 0, 48, 64], id="q1_panel"),
])
@pytest.mark.parametrize("tail", ["none", "empty"])
def test_ops_tailless_branch_matches_reference(qshape, prefix_len, tail):
    """Mirrors ``test_fused_decode.py``'s tail-less test: the port's
    dispatch (``n_blocks = prefix_len // bs``, the partial, zeros where the
    prefix is empty, ``[B, Hq, D]`` in q's dtype) against the reference's
    on its Pallas (interpret) path."""
    jx, tx = _pooled()
    q = rand(qshape, 40)
    sm = 1.0 / D ** 0.5
    jt = tt = None
    if tail == "empty":
        jt = jnp.zeros((B, HKV, 0, D), jnp.float32)
        tt = torch.zeros((B, HKV, 0, D))
    pl_ = None if prefix_len is None else np.asarray(prefix_len, np.int32)
    with jops.backend("interpret"):
        want = jops.sparse_decode_attention(
            jnp.asarray(q), jx[0], jx[1], HKV, sm, jt, jt,
            prefix_len=None if pl_ is None else jnp.asarray(pl_))
    got = tops.sparse_decode_attention(
        torch.from_numpy(q), tx[0], tx[1], HKV, sm, tt, tt,
        prefix_len=None if pl_ is None else torch.from_numpy(pl_))
    assert got.shape == tuple(qshape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if pl_ is not None and pl_.ndim:
        for b in np.flatnonzero(pl_ <= 0):
            assert not got[b].any()
            np.testing.assert_array_equal(np.asarray(want)[b], 0.0)


def test_ops_tailless_panel_raises_as_the_reference():
    jx, tx = _pooled()
    q = rand((B, 3, HKV * 2, D), 41)
    with jops.backend("interpret"), pytest.raises(ValueError, match="tail"):
        jops.sparse_decode_attention(jnp.asarray(q), jx[0], jx[1], HKV, 0.2)
    with pytest.raises(ValueError, match="tail"):
        tops.sparse_decode_attention(torch.from_numpy(q), tx[0], tx[1], HKV,
                                     0.2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [
    pytest.param(None, id="none"), pytest.param(9, id="scalar"),
    pytest.param([0, 1, 16, 5], id="per_slot_with_empty")])
def test_gqa_partial_and_merge_match_ref(dtype, length):
    s, g = 16, 2
    q = rand((B, HKV, g, D), 50)
    k, v = rand((B, HKV, s, D), 51), rand((B, HKV, s, D), 52)
    jq, jk, jv = (jnp.asarray(a, jnp.dtype(dtype)) for a in (q, k, v))
    tq, tk, tv = (bridge.tensor_from_numpy(np.asarray(a), "cpu")
                  for a in (jq, jk, jv))
    jvalid = tvalid = None
    if length is not None:
        ln = np.asarray(length, np.int32)
        jvalid = ref._len_valid(s, jnp.asarray(ln), B)
        tvalid = len_valid(s, torch.from_numpy(ln), B)
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    jo, jl = ref.gqa_partial_ref(jq, jk, jv, 0.2, jvalid)
    to, tl = gqa_partial(tq, tk, tv, 0.2, tvalid)
    tol = 1e-5 if dtype == "float32" else 1e-4
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=tol, atol=tol)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol, atol=tol)
    # merge with a second partial (another key range)
    o2, l2 = rand((B, HKV, g, D), 53), rand((B, HKV, g), 54) * 3
    jm = ref._merge_attn(jo, jl, jnp.asarray(o2), jnp.asarray(l2))
    tm = merge_attn(to, tl, torch.from_numpy(o2), torch.from_numpy(l2))
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=tol)


# ---------------------------------------------------------------------------
# serving: the engine decoding through the two-pass dispatch
# ---------------------------------------------------------------------------

def two_pass_sparse_decode_attention(q, k_sp, v_sp, hkv, sm_scale,
                                     k_tail=None, v_tail=None,
                                     tail_len=None, prefix_len=None):
    """The port's copy of the pre-fusion dispatch of
    ``test_fused_decode.py``: the prefix partial kernel, the grouped tail
    partial and the lse merge.  Decode ticks only (a ``Q == 1`` panel
    squeezes)."""
    if q.dim() == 4:
        assert q.shape[1] == 1, q.shape
        return two_pass_sparse_decode_attention(
            q[:, 0], k_sp, v_sp, hkv, sm_scale, k_tail, v_tail, tail_len,
            prefix_len)[:, None]
    b, hq, d = q.shape
    g = hq // hkv
    bs = k_sp.block[0]
    words, sb = k_sp.bitmap.shape[-1], k_sp.bitmap.shape[2]
    qg = q.reshape(b, hkv, g, d)
    n_blocks = tops._n_blocks(b, sb, bs, prefix_len, q.device)
    o, lse = sparse_decode_attention_partial(
        qg, k_sp.bitmap.reshape(b, hkv, sb, words),
        k_sp.values.reshape(b, hkv, sb, k_sp.capacity),
        v_sp.bitmap.reshape(b, hkv, sb, words),
        v_sp.values.reshape(b, hkv, sb, v_sp.capacity), bs, sm_scale,
        n_blocks)
    # an empty prefix gives o = 0 and lse = -1e30 (the kernel's NEG_INF)
    o, lse = o.reshape(b, hq, d), lse.reshape(b, hq)
    if k_tail is not None and k_tail.shape[2] > 0:
        t = k_tail.shape[2]
        valid = len_valid(t, tail_len if tail_len is not None else t, b)
        o2, lse2 = gqa_partial(qg, k_tail, v_tail, sm_scale, valid)
        o2, lse2 = o2.reshape(b, hq, d), lse2.reshape(b, hq)
        empty = ~valid.any(-1)
        lse2 = torch.where(empty[:, None], torch.tensor(float("-inf")), lse2)
        lse2 = torch.where(torch.isfinite(lse2), lse2, lse.min() - 60.0)
        o, _ = merge_attn(o, lse, o2, lse2)
    return o.to(q.dtype)


def _waves(make_engine, params_cls, toks):
    """A lockstep pair of 24 tokens (past the 16-token ring: refreezes),
    then a staggered wave of three through two slots with unaligned
    prompts (admission from the queue, evictions, tail remainders)."""
    eng = make_engine()
    first = eng.generate_batch(toks, params_cls(max_new_tokens=24))
    rids = [eng.submit(toks[i % 2][:9 + 4 * i],
                       params_cls(max_new_tokens=20 - 2 * i))
            for i in range(3)]
    res = eng.run()
    return np.asarray(first).tolist(), [list(res[r].token_ids) for r in rids]


def test_two_pass_engine_matches_fused_and_reference(monkeypatch):
    """Mirrors ``test_fused_decode.py``'s engine parity: the reduced f32
    engine decoding through the two-pass dispatch is token-identical to the
    port's fused engine and to the reference engine."""
    jcfg, tcfg = configs("float32", kv_tail=16)
    jparams, tparams = sparse_params(jcfg, tcfg)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 16))
    make = lambda: ContinuousEngine(tparams, tcfg, slots=2, max_tokens=96,
                                    bs=16, device="cpu")
    ref_tokens = _waves(lambda: JaxEngine(jparams, jcfg, slots=2,
                                          max_tokens=96, bs=16),
                        JaxParams, jnp.asarray(toks, jnp.int32))
    fused = _waves(make, SamplingParams, toks)
    calls = []
    monkeypatch.setattr(tops, "sparse_decode_attention",
                        lambda *a, **k: calls.append(1)
                        or two_pass_sparse_decode_attention(*a, **k))
    two_pass = _waves(make, SamplingParams, toks)
    assert calls
    assert two_pass == fused
    assert fused == ref_tokens
