"""The four kernels' plain versions against the reference Pallas kernels,
run in interpret mode at f32 (rtol/atol 1e-5), plus the dispatch rules of
``repro_torch.kernels.ops``.  The fused attention is held over the pooled
edge grid of ``test_fused_decode.py`` with poisoned storage past every
slot's valid lengths, so a masking leak breaks parity loudly."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import make_mask, pack
from repro.core.sparse_kv import freeze_chunk_blocks, pooled_view
from repro.kernels import ops as jops
from repro.kernels.dense_matmul import dense_matmul_pallas
from repro.kernels.sparse_attention import \
    sparse_decode_attention_fused_pallas
from repro.kernels.sparse_gemv import sparse_gemv_pallas
from repro.kernels.sparse_matmul import sparse_matmul_pallas

from repro_torch import bridge
from repro_torch.core.sparse_format import unpack
from repro_torch.kernels import ops as tops
from repro_torch.kernels.dense_matmul import dense_matmul, \
    dense_matmul_plain
from repro_torch.kernels.sparse_attention import (
    sparse_decode_attention_fused, sparse_decode_attention_fused_plain)
from repro_torch.kernels.sparse_gemv import sparse_gemv, sparse_gemv_plain
from repro_torch.kernels.sparse_matmul import sparse_matmul, \
    sparse_matmul_f32, sparse_matmul_plain

from torch_parity import rand, to_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


def _sparse(k, n, value_dtype, seed, block=(128, 128)):
    """(reference weight at the model's fan-in scale, the port's bridged
    copy of the same bytes)."""
    w = jnp.asarray(rand((k, n), seed) / np.sqrt(k))
    mask = make_mask(w, 0.5, "balanced", block)
    jsw = pack(w.astype(value_dtype), mask, block)
    return jsw, bridge.params_from_numpy({"w": to_numpy(jsw)}, None)["w"]


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                               **TOL)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("values", ["float32", "bfloat16"])
def test_sparse_gemv_plain_matches_pallas(m, values):
    jsw, tsw = _sparse(384, 256, jnp.dtype(values), seed=m)
    x = rand((m, 384), 10 + m)
    ref = sparse_gemv_pallas(jnp.asarray(x), jsw, interpret=True)
    _close(sparse_gemv_plain(torch.from_numpy(x), tsw), ref)


@pytest.mark.parametrize("m,k,n", [(16, 256, 384), (40, 200, 100)])
@pytest.mark.parametrize("values", ["float32", "bfloat16"])
def test_sparse_matmul_plain_matches_pallas(m, k, n, values):
    jsw, tsw = _sparse(k, n, jnp.dtype(values), seed=k)
    x = rand((m, k), 20 + m)
    ref = sparse_matmul_pallas(jnp.asarray(x), jsw, tm=16, interpret=True)
    _close(sparse_matmul_plain(torch.from_numpy(x), tsw), ref)


@pytest.mark.parametrize("m,k,n", [(1, 128, 384), (5, 200, 100),
                                   (8, 256, 128), (4, 256, 384),
                                   (20, 128, 256), (36, 200, 100)])
def test_dense_matmul_plain_matches_pallas(m, k, n):
    """The port reads the weight as rows ``[N, K]`` (the tied embedding
    table itself); the reference takes ``w [K, N]``."""
    x, w = rand((m, k), 30), rand((k, n), 31) / np.sqrt(k)
    ref = dense_matmul_pallas(jnp.asarray(x), jnp.asarray(w),
                              block=(128, 128, 128), out_dtype=jnp.float32,
                              interpret=True)
    got = dense_matmul_plain(torch.from_numpy(x),
                             torch.from_numpy(np.ascontiguousarray(w.T)),
                             torch.float32)
    _close(got, ref)


# ---------------------------------------------------------------------------
# fused decode attention
# ---------------------------------------------------------------------------

B, HKV, G, D, SB, BS, T = 4, 2, 2, 32, 4, 16, 16


def _attention_case(n_blocks, tail_len, qn, ks=0.3, vs=0.5, seed=0):
    """Kernel-layout operands (numpy), poisoned past the valid lengths:
    prefix blocks past ``n_blocks`` and tail tokens past what the last
    panel query may see hold large values."""
    k = rand((B, HKV, SB * BS, D), seed)
    v = rand((B, HKV, SB * BS, D), seed + 1)
    for b, nb in enumerate(n_blocks):
        k[b, :, nb * BS:] = 50.0
        v[b, :, nb * BS:] = 50.0
    cap = BS * D
    kbm, kvl, vbm, vvl = (np.asarray(a) for a in freeze_chunk_blocks(
        jnp.asarray(k), jnp.asarray(v), ks, vs, BS, cap, cap))
    kt = rand((B, HKV, T, D), seed + 2)
    vt = rand((B, HKV, T, D), seed + 3)
    for b, tl in enumerate(tail_len):
        kt[b, :, tl + qn - 1:] = 50.0
        vt[b, :, tl + qn - 1:] = 50.0
    q = rand((B, HKV, qn * G, D), seed + 4)
    return q, kbm, kvl, vbm, vvl, kt, vt


EDGE_GRID = [
    # (prefix blocks per slot, tail_len per slot)
    pytest.param([4, 4, 4, 4], [0, 0, 0, 0], id="empty_tail"),
    pytest.param([4, 4, 4, 4], [1, 1, 1, 1], id="one_token_tail"),
    pytest.param([4, 4, 4, 4], [16, 16, 16, 16], id="full_tail"),
    pytest.param([0, 0, 0, 0], [7, 16, 1, 9], id="empty_prefix"),
    pytest.param([0, 0, 0, 0], [0, 0, 0, 0], id="all_empty"),
    pytest.param([0, 4, 2, 1], [0, 1, 16, 9], id="mixed_lengths"),
]


@pytest.mark.parametrize("n_blocks,tail_len", EDGE_GRID)
@pytest.mark.parametrize("qn", [1, 2])
def test_fused_attention_plain_matches_pallas(n_blocks, tail_len, qn):
    tail_len = [min(t, T - qn + 1) for t in tail_len]   # panel fits the ring
    arrays = _attention_case(n_blocks, tail_len, qn)
    nb = np.asarray(n_blocks, np.int32)
    tl = np.asarray(tail_len, np.int32)
    sm = 1.0 / D ** 0.5
    ref = sparse_decode_attention_fused_pallas(
        *(jnp.asarray(a) for a in arrays), bs=BS, sm_scale=sm,
        interpret=True, n_blocks=jnp.asarray(nb), tail_len=jnp.asarray(tl),
        group=G)
    t = [bridge.tensor_from_numpy(a, "cpu") for a in arrays]
    got = sparse_decode_attention_fused_plain(
        *t, BS, sm, torch.from_numpy(nb), torch.from_numpy(tl), G)
    _close(got, ref)
    if not (nb.any() or tl.any()):
        # panel query 0 of an all-empty slot sees nothing: exact zeros
        assert not got[:, :, :G].any()


# ---------------------------------------------------------------------------
# ops dispatch
# ---------------------------------------------------------------------------

def _pooled(seed=0, t=T):
    """A pooled prefix view + dense tail for both packages."""
    k = rand((B, HKV, SB * BS, D), seed)
    v = rand((B, HKV, SB * BS, D), seed + 1)
    cap = BS * D
    jk = freeze_chunk_blocks(jnp.asarray(k), jnp.asarray(v), 0.3, 0.5, BS,
                             cap, cap)
    jk_sp, jv_sp = pooled_view(jk[0], jk[1], BS, D), \
        pooled_view(jk[2], jk[3], BS, D)
    from repro_torch.core.sparse_kv import pooled_view as tview
    tk = [bridge.tensor_from_numpy(np.asarray(a), "cpu") for a in jk]
    tk_sp, tv_sp = tview(tk[0], tk[1], BS, D), tview(tk[2], tk[3], BS, D)
    kt, vt = rand((B, HKV, t, D), seed + 2), rand((B, HKV, t, D), seed + 3)
    return (jk_sp, jv_sp, jnp.asarray(kt), jnp.asarray(vt)), \
        (tk_sp, tv_sp, torch.from_numpy(kt), torch.from_numpy(vt))


DISPATCH = [
    # (query shape, ring length, tail_len, prefix_len)
    pytest.param((B, HKV * G, D), T, [0, 1, 16, 9], None, id="decode"),
    pytest.param((B, 1, HKV * G, D), T, [3, 1, 16, 0], [64, 0, 32, 16],
                 id="q1_panel_squeezes"),
    pytest.param((B, 3, HKV * G, D), T, [0, 5, 14, 9], [0, 64, 16, 48],
                 id="q3_panel_query_major"),
    pytest.param((B, HKV * G, D), 11, [0, 1, 11, 5], [16, 0, 64, 32],
                 id="unaligned_ring_padded"),
]


@pytest.mark.parametrize("qshape,t,tail_len,prefix_len", DISPATCH)
def test_ops_attention_dispatch_matches_reference(qshape, t, tail_len,
                                                  prefix_len):
    """Panel squeeze, query-major GQA rows, ring padding and
    ``n_blocks = prefix_len // bs``: the port's dispatch against the
    reference's on its Pallas (interpret) path."""
    jx, tx = _pooled(t=t)
    q = rand(qshape, 40)
    tl = np.asarray(tail_len, np.int32)
    pl_ = None if prefix_len is None else np.asarray(prefix_len, np.int32)
    sm = 1.0 / D ** 0.5
    with jops.backend("interpret"):
        ref = jops.sparse_decode_attention(
            jnp.asarray(q), jx[0], jx[1], HKV, sm, jx[2], jx[3],
            jnp.asarray(tl), None if pl_ is None else jnp.asarray(pl_))
    got = tops.sparse_decode_attention(
        torch.from_numpy(q), tx[0], tx[1], HKV, sm, tx[2], tx[3],
        torch.from_numpy(tl), None if pl_ is None else torch.from_numpy(pl_))
    assert got.shape == tuple(qshape)
    _close(got, ref)


def test_q1_panel_is_the_decode_tick_exactly():
    _, tx = _pooled()
    q = torch.from_numpy(rand((B, HKV * G, D), 41))
    tl = torch.tensor([2, 0, 16, 7], dtype=torch.int32)
    pl_ = torch.tensor([0, 64, 32, 16], dtype=torch.int32)
    tick = tops.sparse_decode_attention(q, tx[0], tx[1], HKV, 0.2, tx[2],
                                        tx[3], tl, pl_)
    panel = tops.sparse_decode_attention(q[:, None], tx[0], tx[1], HKV, 0.2,
                                         tx[2], tx[3], tl, pl_)
    assert torch.equal(panel[:, 0], tick)


@pytest.mark.parametrize("lead,rows,path", [((2, 3), 6, "gemv"),
                                             ((8,), 8, "gemv"),
                                             ((3, 3), 9, "matmul")])
def test_ops_routes_at_most_8_rows_to_gemv(monkeypatch, lead, rows, path):
    _, tsw = _sparse(256, 128, jnp.float32, seed=5)
    seen = []
    monkeypatch.setattr(tops, "sparse_gemv", lambda x, sw, od=None: (
        seen.append(("gemv", x.shape[0])) or sparse_gemv_plain(x, sw, od)))
    monkeypatch.setattr(tops, "_sparse_matmul_kernel", lambda x, sw, od=None: (
        seen.append(("matmul", x.shape[0])) or sparse_matmul_plain(x, sw, od)))
    x = torch.from_numpy(rand(lead + (256,), 6))
    out = tops.linear(x, tsw)
    assert seen == [(path, rows)]
    assert out.shape == lead + (128,)
    torch.testing.assert_close(out.reshape(rows, 128),
                               x.reshape(rows, 256) @ unpack(tsw), **TOL)


def test_linear_dense_reads_the_transposed_view():
    """A dense ``[K, N]`` weight that is a transposed view of rows (the tied
    embedding) reaches the kernel as the rows themselves, no copy."""
    rows = torch.from_numpy(rand((300, 64), 7))
    x = torch.from_numpy(rand((3, 64), 8))
    out = tops.linear(x, rows.T, out_dtype=torch.float32)
    _close(out, np.asarray(jnp.asarray(x.numpy()) @ jnp.asarray(
        rows.numpy().T)))


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    _, tsw = _sparse(256, 128, jnp.bfloat16, seed=9)
    x = torch.from_numpy(rand((4, 256), 10))
    _, tx = _pooled()
    q = torch.from_numpy(rand((B, HKV, G, D), 11))
    kbm, kvl = tx[0].bitmap[:, :, :, 0], tx[0].values[:, :, :, 0]
    vbm, vvl = tx[1].bitmap[:, :, :, 0], tx[1].values[:, :, :, 0]
    nb = torch.tensor([0, 1, 4, 2], dtype=torch.int32)
    tl = torch.tensor([3, 0, 16, 1], dtype=torch.int32)
    kernels = (sparse_gemv, sparse_matmul, dense_matmul,
               sparse_decode_attention_fused)
    before = [k.launches for k in kernels]
    assert torch.equal(sparse_gemv(x, tsw), sparse_gemv_plain(x, tsw))
    assert torch.equal(sparse_matmul(x, tsw), sparse_matmul_plain(x, tsw))
    assert torch.equal(dense_matmul(x, x), dense_matmul_plain(x, x))
    args = (q, kbm, kvl, vbm, vvl, tx[2], tx[3], BS, 0.2, nb, tl, G)
    assert torch.equal(sparse_decode_attention_fused(*args),
                       sparse_decode_attention_fused_plain(*args))
    assert [k.launches for k in kernels] == before


@pytest.mark.parametrize("values", ["float32", "bfloat16"])
def test_f32_sparse_matmul_takes_the_plain_version_on_the_cpu(values):
    """The f32-activation kernel (an engine served at f32) has its own
    wrapper and counter; on CPU tensors both wrappers take the plain
    version and count nothing."""
    _, tsw = _sparse(256, 128, jnp.dtype(values), seed=15)
    x = torch.from_numpy(rand((20, 256), 16))
    before = sparse_matmul_f32.launches, sparse_matmul.launches
    want = sparse_matmul_plain(x, tsw)
    assert torch.equal(sparse_matmul_f32(x, tsw), want)
    assert torch.equal(sparse_matmul(x, tsw), want)
    assert (sparse_matmul_f32.launches, sparse_matmul.launches) == before


def test_unported_paths_raise():
    """A query panel without a tail and an int8 weight without its
    per-channel scale are refused as the reference refuses them (the
    tail-less single-query attention is ported:
    ``test_torch_attention_partial.py``)."""
    jsw, tsw = _sparse(256, 128, jnp.float32, seed=12)
    x = torch.from_numpy(rand((2, 256), 13))
    int8 = bridge.params_from_numpy(
        {"w": {**to_numpy(jsw), "values": np.zeros(
            np.asarray(jsw.values).shape, np.int8)}}, None)["w"]
    with pytest.raises(ValueError, match="scale"):
        tops.linear(x, int8)
    _, tx = _pooled()
    q = torch.from_numpy(rand((B, 2, HKV * G, D), 14))
    with pytest.raises(ValueError, match="tail"):
        tops.sparse_decode_attention(q, tx[0], tx[1], HKV, 0.2, None, None)
