"""Dispatch over the kernels (twin of ``repro.kernels.ops``).

Each kernel wrapper launches its CUDA kernel for CUDA tensors and takes its
plain version only for CPU tensors, so the device of the operands is the
only switch.  The dispatch rules are the reference's:

* at most 8 rows go to the gemv kernel (``ops.py:87``), more to the matmul;
* int8 and int4 weights take the int kernel at every row count (the
  reference has no gemv split for them); the activations are quantised
  per row in plain PyTorch first, outside the kernel, as in the reference;
* a ``Q == 1`` attention panel squeezes onto the single-query dispatch;
* attention without a tail takes the prefix-only partial kernel, and a
  slot whose prefix is empty gets exactly zero;
* the tail ring is zero-padded to whole ``bs``-token panels;
* ``n_blocks = prefix_len // bs``;
* GQA query rows are ordered query-major within each group.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quant import quantize_act_int8
from repro_torch.core.sparse_format import BlockSparseWeight
from .dense_matmul import DenseMatmulGrad
from .dense_matmul import dense_matmul as _dense_kernel
from .sparse_attention import (sparse_decode_attention_fused,
                               sparse_decode_attention_fused_paged,
                               sparse_decode_attention_partial)
from .sparse_gemv import MAX_ROWS, sparse_gemv
from .sparse_matmul import sparse_matmul as _sparse_matmul_kernel
from .sparse_matmul_int4 import sparse_matmul_int4 as _int4_kernel
from .sparse_matmul_int8 import sparse_matmul_int8 as _int8_kernel


def _flatten_leading(x: torch.Tensor):
    return x.reshape(-1, x.shape[-1]), x.shape[:-1]


def dense_matmul(x: torch.Tensor, w: torch.Tensor,
                 out_dtype=None) -> torch.Tensor:
    """``x [..., K] @ w [K, N]``.  The kernel reads the weight as rows
    ``[N, K]``, so ``w`` is typically a transposed view (``tok.T``) and no
    copy is made.  Under autograd (grad mode on and an operand that
    requires grad: a train step) the same kernel runs inside
    :class:`DenseMatmulGrad`; serving calls it directly, as before."""
    x2, lead = _flatten_leading(x)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        out = DenseMatmulGrad.apply(x2, w.t(), out_dtype, _dense_kernel)
    else:
        out = _dense_kernel(x2, w.t(), out_dtype)
    return out.reshape(*lead, w.shape[-1])


def sparse_matmul(x: torch.Tensor, sw: BlockSparseWeight,
                  out_dtype=None) -> torch.Tensor:
    x2, lead = _flatten_leading(x)
    if x2.shape[0] <= MAX_ROWS:
        out = sparse_gemv(x2, sw, out_dtype)
    else:
        out = _sparse_matmul_kernel(x2, sw, out_dtype)
    return out.reshape(*lead, out.shape[-1])


def sparse_matmul_int8(x: torch.Tensor, sw: BlockSparseWeight,
                       out_dtype=None) -> torch.Tensor:
    """``x @ dequant(sw)`` for int8 or nibble-packed int4 values: per-row
    int8 activation quantisation, then the int kernel (``packed4`` picks
    the int4 instantiation)."""
    if not ((sw.values.dtype == torch.int8 or sw.packed4)
            and sw.scale is not None):
        raise ValueError("int path needs int8/int4 values and a scale")
    out_dtype = out_dtype or x.dtype
    x2, lead = _flatten_leading(x)
    xq, sx = quantize_act_int8(x2)
    kernel = _int4_kernel if sw.packed4 else _int8_kernel
    out = kernel(xq, sx, sw, out_dtype)
    return out.reshape(*lead, out.shape[-1])


def linear(x: torch.Tensor, w, out_dtype=None) -> torch.Tensor:
    """A linear layer whose weight is dense, sparse-bf16, or sparse-int8 /
    int4: callers never branch on the storage format."""
    if isinstance(w, BlockSparseWeight):
        if w.packed4 or w.values.dtype == torch.int8:
            return sparse_matmul_int8(x, w, out_dtype)
        return sparse_matmul(x, w, out_dtype)
    return dense_matmul(x, w, out_dtype)


def _panel_rows(q: torch.Tensor, hkv: int):
    """q ``[B, Hq, D]`` or ``[B, Q, Hq, D]`` -> the kernel's query rows
    ``[B, Hkv, Q*G, D]``, query-major within each GQA group (row // G is
    the panel index), and ``(Q, G)``."""
    if q.dim() == 4:
        b, qn, hq, d = q.shape
        g = hq // hkv
        return (q.reshape(b, qn, hkv, g, d).permute(0, 2, 1, 3, 4)
                .reshape(b, hkv, qn * g, d)), qn, g
    b, hq, d = q.shape
    return q.reshape(b, hkv, hq // hkv, d), 1, hq // hkv


def _panel_out(o: torch.Tensor, q: torch.Tensor, qn: int, g: int
               ) -> torch.Tensor:
    """The kernel's f32 rows back to the layout and dtype of ``q``."""
    b, hkv, _, d = o.shape
    if q.dim() == 4:
        return (o.reshape(b, hkv, qn, g, d).permute(0, 2, 1, 3, 4)
                .reshape(b, qn, hkv * g, d).to(q.dtype))
    return o.reshape(b, hkv * g, d).to(q.dtype)


def _n_blocks(b: int, sb: int, bs: int, prefix_len, dev) -> torch.Tensor:
    """Per-slot ``n_blocks = prefix_len // bs`` (every block when None)."""
    if prefix_len is None:
        return torch.full((b,), sb, dtype=torch.int32, device=dev)
    return torch.broadcast_to(
        torch.as_tensor(prefix_len, device=dev).to(torch.int32) // bs, (b,))


def _lengths(b: int, sb: int, bs: int, k_tail, v_tail, tail_len,
             prefix_len, dev):
    """Per-slot ``n_blocks`` and visible tail lengths, and the ring
    zero-padded to whole ``bs``-token panels (the padding is masked by the
    tail length)."""
    n_blocks = _n_blocks(b, sb, bs, prefix_len, dev)
    t = k_tail.shape[2]
    tl = torch.broadcast_to(torch.as_tensor(
        t if tail_len is None else tail_len, device=dev).to(torch.int32),
        (b,))
    pad = -t % bs
    if pad:
        k_tail = F.pad(k_tail, (0, 0, 0, pad))
        v_tail = F.pad(v_tail, (0, 0, 0, pad))
    return n_blocks, tl, k_tail, v_tail


def sparse_decode_attention(q: torch.Tensor,
                            k_sp: BlockSparseWeight,
                            v_sp: BlockSparseWeight,
                            hkv: int,
                            sm_scale: float,
                            k_tail: Optional[torch.Tensor] = None,
                            v_tail: Optional[torch.Tensor] = None,
                            tail_len: Optional[torch.Tensor] = None,
                            prefix_len: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Decode attention over a compressed frozen prefix + dense tail.

    q ``[B, Hq, D]`` (a decode tick) or ``[B, Q, Hq, D]`` (a query panel);
    ``k_sp``/``v_sp`` the pooled view (bitmap ``[B, Hkv, Sb, 1, X]``);
    ``k_tail``/``v_tail`` ``[B, Hkv, T, D]``; ``tail_len`` / ``prefix_len``
    scalar or per-slot ``[B]``.  With a tail, one fused kernel launch
    produces the final output.  Without one (``k_tail`` None or empty) the
    prefix-only partial kernel runs and its normalised output is returned;
    a slot whose prefix is empty (``prefix_len <= 0``) gets exactly zero.
    A query panel needs a tail: it appends into it."""
    has_tail = k_tail is not None and k_tail.shape[2] > 0
    if q.dim() == 4 and q.shape[1] == 1:
        # a 1-wide panel IS a decode tick: squeeze onto the single query
        o = sparse_decode_attention(q[:, 0], k_sp, v_sp, hkv, sm_scale,
                                    k_tail, v_tail, tail_len, prefix_len)
        return o[:, None]
    if q.dim() == 4 and not has_tail:
        raise ValueError("query panels append into (and need) a dense tail")
    d = q.shape[-1]
    b = q.shape[0]
    bs = k_sp.block[0]
    if k_sp.block[1] != d:
        raise ValueError(f"KV block width {k_sp.block[1]} must equal head "
                         f"dim {d}")
    words = k_sp.bitmap.shape[-1]
    sb = k_sp.bitmap.shape[2]
    qg, qn, g = _panel_rows(q, hkv)
    kbm = k_sp.bitmap.reshape(b, hkv, sb, words)
    kvv = k_sp.values.reshape(b, hkv, sb, k_sp.capacity)
    vbm = v_sp.bitmap.reshape(b, hkv, sb, words)
    vvv = v_sp.values.reshape(b, hkv, sb, v_sp.capacity)
    if not has_tail:
        n_blocks = _n_blocks(b, sb, bs, prefix_len, q.device)
        # a slot with no valid block (prefix_len < bs) gets o = 0 exactly
        o, _ = sparse_decode_attention_partial(qg, kbm, kvv, vbm, vvv, bs,
                                               sm_scale, n_blocks)
        return o.reshape(b, hkv * g, d).to(q.dtype)
    n_blocks, tl, k_tail, v_tail = _lengths(b, sb, bs, k_tail, v_tail,
                                            tail_len, prefix_len, q.device)
    o = sparse_decode_attention_fused(qg, kbm, kvv, vbm, vvv, k_tail, v_tail,
                                      bs, sm_scale, n_blocks, tl, group=g)
    return _panel_out(o, q, qn, g)


def sparse_decode_attention_paged(q: torch.Tensor,
                                  k_bitmap: torch.Tensor,
                                  k_values: torch.Tensor,
                                  v_bitmap: torch.Tensor,
                                  v_values: torch.Tensor,
                                  table: torch.Tensor,
                                  hkv: int,
                                  sm_scale: float,
                                  bs: int,
                                  k_tail: torch.Tensor,
                                  v_tail: torch.Tensor,
                                  tail_len: Optional[torch.Tensor] = None,
                                  prefix_len: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Paged twin of :func:`sparse_decode_attention` (``repro/kernels/
    ops.py:249-321``): the compressed prefix lives once in a pool-global
    arena ``k_bitmap [n_phys, Hkv, w]`` / ``k_values [n_phys, Hkv, Ck]``
    (same for v) and slot ``b`` reaches its logical block ``i`` through
    ``table[b, i]`` (int32 ``[B, Sb]``; entries past ``prefix_len // bs``
    are dead but in range).  q, tail and lengths as the flat entry, with the
    same ``Q == 1`` squeeze; paging changes only where prefix blocks are
    fetched from."""
    if q.dim() == 4 and q.shape[1] == 1:
        o = sparse_decode_attention_paged(
            q[:, 0], k_bitmap, k_values, v_bitmap, v_values, table, hkv,
            sm_scale, bs, k_tail, v_tail, tail_len, prefix_len)
        return o[:, None]
    b = q.shape[0]
    qg, qn, g = _panel_rows(q, hkv)
    n_blocks, tl, k_tail, v_tail = _lengths(b, table.shape[1], bs, k_tail,
                                            v_tail, tail_len, prefix_len,
                                            q.device)
    o = sparse_decode_attention_fused_paged(
        qg, k_bitmap, k_values, v_bitmap, v_values, table, k_tail, v_tail,
        bs, sm_scale, n_blocks, tl, group=g)
    return _panel_out(o, q, qn, g)
