"""Dispatch over the kernels (twin of ``repro.kernels.ops``).

Each kernel wrapper launches its CUDA kernel for CUDA tensors and takes its
plain version only for CPU tensors, so the device of the operands is the
only switch.  The dispatch rules are the reference's:

* at most 8 rows go to the gemv kernel (``ops.py:87``), more to the matmul;
* a ``Q == 1`` attention panel squeezes onto the single-query dispatch;
* the tail ring is zero-padded to whole ``bs``-token panels;
* ``n_blocks = prefix_len // bs``;
* GQA query rows are ordered query-major within each group.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_format import BlockSparseWeight
from .dense_matmul import dense_matmul as _dense_kernel
from .sparse_attention import sparse_decode_attention_fused
from .sparse_gemv import MAX_ROWS, sparse_gemv
from .sparse_matmul import sparse_matmul as _sparse_matmul_kernel


def _flatten_leading(x: torch.Tensor):
    return x.reshape(-1, x.shape[-1]), x.shape[:-1]


def dense_matmul(x: torch.Tensor, w: torch.Tensor,
                 out_dtype=None) -> torch.Tensor:
    """``x [..., K] @ w [K, N]``.  The kernel reads the weight as rows
    ``[N, K]``, so ``w`` is typically a transposed view (``tok.T``) and no
    copy is made."""
    x2, lead = _flatten_leading(x)
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


def linear(x: torch.Tensor, w, out_dtype=None) -> torch.Tensor:
    """A linear layer whose weight is dense or sparse-bf16: callers never
    branch on the storage format."""
    if isinstance(w, BlockSparseWeight):
        if w.packed4 or w.values.dtype == torch.int8:
            raise NotImplementedError("int8/int4 sparse weights are not "
                                      "ported yet")
        return sparse_matmul(x, w, out_dtype)
    return dense_matmul(x, w, out_dtype)


def sparse_decode_attention(q: torch.Tensor,
                            k_sp: BlockSparseWeight,
                            v_sp: BlockSparseWeight,
                            hkv: int,
                            sm_scale: float,
                            k_tail: torch.Tensor,
                            v_tail: torch.Tensor,
                            tail_len: Optional[torch.Tensor] = None,
                            prefix_len: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Decode attention over a compressed frozen prefix + dense tail.

    q ``[B, Hq, D]`` (a decode tick) or ``[B, Q, Hq, D]`` (a query panel);
    ``k_sp``/``v_sp`` the pooled view (bitmap ``[B, Hkv, Sb, 1, X]``);
    ``k_tail``/``v_tail`` ``[B, Hkv, T, D]``; ``tail_len`` / ``prefix_len``
    scalar or per-slot ``[B]``.  One fused kernel launch produces the final
    output.  (The reference's tail-less prefix-partial branch belongs to the
    context-parallel path, which is not ported yet.)"""
    if k_tail is None or k_tail.shape[2] == 0:
        raise NotImplementedError("the prefix-only attention (no tail) is "
                                  "not ported yet")
    if q.dim() == 4 and q.shape[1] == 1:
        # a 1-wide panel IS a decode tick: squeeze onto the single query
        o = sparse_decode_attention(q[:, 0], k_sp, v_sp, hkv, sm_scale,
                                    k_tail, v_tail, tail_len, prefix_len)
        return o[:, None]
    panel = q.dim() == 4
    if panel:
        b, qn, hq, d = q.shape
    else:
        b, hq, d = q.shape
        qn = 1
    g = hq // hkv
    bs = k_sp.block[0]
    if k_sp.block[1] != d:
        raise ValueError(f"KV block width {k_sp.block[1]} must equal head "
                         f"dim {d}")
    words = k_sp.bitmap.shape[-1]
    sb = k_sp.bitmap.shape[2]
    if panel:
        # query-major rows within each GQA group: row // g = panel index
        qg = (q.reshape(b, qn, hkv, g, d).permute(0, 2, 1, 3, 4)
              .reshape(b, hkv, qn * g, d))
    else:
        qg = q.reshape(b, hkv, g, d)
    kbm = k_sp.bitmap.reshape(b, hkv, sb, words)
    kvv = k_sp.values.reshape(b, hkv, sb, k_sp.capacity)
    vbm = v_sp.bitmap.reshape(b, hkv, sb, words)
    vvv = v_sp.values.reshape(b, hkv, sb, v_sp.capacity)
    dev = q.device
    if prefix_len is None:
        n_blocks = torch.full((b,), sb, dtype=torch.int32, device=dev)
    else:
        n_blocks = torch.broadcast_to(
            torch.as_tensor(prefix_len, device=dev).to(torch.int32) // bs,
            (b,))
    t = k_tail.shape[2]
    tl = torch.broadcast_to(torch.as_tensor(
        t if tail_len is None else tail_len, device=dev).to(torch.int32),
        (b,))
    # pad the ring to whole (bs,)-token panels; padding is masked by tl
    pad = -t % bs
    if pad:
        k_tail = F.pad(k_tail, (0, 0, 0, pad))
        v_tail = F.pad(v_tail, (0, 0, 0, pad))
    o = sparse_decode_attention_fused(qg, kbm, kvv, vbm, vvv, k_tail, v_tail,
                                      bs, sm_scale, n_blocks, tl, group=g)
    if panel:
        return (o.reshape(b, hkv, qn, g, d).permute(0, 2, 1, 3, 4)
                .reshape(b, qn, hq, d).to(q.dtype))
    return o.reshape(b, hq, d).to(q.dtype)
