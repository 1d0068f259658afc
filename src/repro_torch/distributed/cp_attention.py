"""Context-parallel sparse-KV flash-decode (twin of
``repro.distributed.cp_attention``).

Each rank of the context axis attends over its own contiguous share of
the compressed prefix blocks with the hand-written split kernel in partial
mode (``kernels/sparse_attention.py::sparse_decode_attention_partial``,
``n_blocks`` clipped to the share), which returns the flash partial
``(o_i, lse_i)``; the partials merge with two small collectives a layer:

    m*  = all_reduce(MAX, lse_i)
    w_i = exp(lse_i - m*)
    o   = all_reduce(SUM, [o_i * w_i | w_i]) -> num / den

The dense tail is computed redundantly on every rank (``gqa_partial``) and
merged locally after the combine (``merge_attn``), under the reference's
empty-tail rule, so it never enters a collective.

The reference shards the batch over the data axes when it divides and
the blocks over the remaining axes.  In the port a rank's one-shot batch
is its data shard already (the caller feeds each data rank its rows), so
the context axis is the model axis.  Where the block count does not divide
the context axis, the rank computes the same function alone through the
one-rank kernels (``ops.sparse_decode_attention``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.sparse_kv import SparseKVCache
from repro_torch.kernels import ops
from repro_torch.kernels.sparse_attention import (gqa_partial, len_valid,
                                                  merge_attn,
                                                  sparse_decode_attention_partial)
from .sharding import all_reduce, mesh_axis_size, shard_index


def context_axes(ctx):
    """The mesh axes the prefix blocks split over (the model axis), or ()
    when the ctx has no mesh."""
    tp = ctx.rules.get("ffn") if ctx.mesh is not None else None
    return (tp,) if tp is not None else ()


def sparse_decode_attention_cp(q: torch.Tensor, cache: SparseKVCache,
                               hkv: int, sm_scale: float, ctx,
                               prefix_len: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """q ``[B, Hq, D]`` over a structured cache (bitmap ``[B, Hkv, Sb, 1,
    W]``); ``prefix_len`` (int ``[B]``, default every block) masks each
    slot's prefix as the reference oracle's does.  Returns ``[B, Hq, D]``
    in q's dtype."""
    kb = cache.k_sp.bitmap
    if kb.dim() != 5:
        raise ValueError("context-parallel path needs the structured layout")
    b, hq, d = q.shape
    sb = kb.shape[2]
    bs = cache.k_sp.block[0]
    axes = context_axes(ctx)
    n = mesh_axis_size(ctx.mesh, axes)
    if n <= 1 or sb % n != 0:
        return ops.sparse_decode_attention(
            q, cache.k_sp, cache.v_sp, hkv, sm_scale, cache.k_tail,
            cache.v_tail, cache.tail_len, prefix_len)
    share = sb // n
    r0 = shard_index(ctx.mesh, axes) * share
    dev = q.device
    full = (torch.full((b,), sb, dtype=torch.int32, device=dev)
            if prefix_len is None else
            torch.as_tensor(prefix_len, device=dev).to(torch.int32) // bs)
    n_local = (full - r0).clamp(0, share).to(torch.int32)

    def local(sw):
        return (sw.bitmap[:, :, r0:r0 + share].reshape(b, hkv, share, -1)
                .contiguous(),
                sw.values[:, :, r0:r0 + share].reshape(b, hkv, share, -1)
                .contiguous())
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d)
    o, lse = sparse_decode_attention_partial(
        qg, *local(cache.k_sp), *local(cache.v_sp), bs, sm_scale, n_local)
    m_star = all_reduce(lse, ctx.mesh, axes, "max")
    w = torch.exp(lse - m_star)
    both = all_reduce(torch.cat([o * w[..., None], w[..., None]], dim=-1),
                      ctx.mesh, axes, "sum")
    num, den = both[..., :d], both[..., d]
    o_pref = num / torch.clamp(den, min=1e-30)[..., None]
    lse_pref = m_star + torch.log(torch.clamp(den, min=1e-30))
    # the dense tail: small, computed on every rank, merged locally
    t = cache.k_tail.shape[2]
    if t > 0:
        valid = len_valid(t, cache.tail_len, b)
        o_t, lse_t = gqa_partial(qg, cache.k_tail, cache.v_tail, sm_scale,
                                 valid)
        empty = ~valid.any(-1)
        lse_t = torch.where(empty[:, None, None], lse_pref - 60.0, lse_t)
        lse_t = torch.where(torch.isfinite(lse_t), lse_t, lse_pref - 60.0)
        o_pref, _ = merge_attn(o_pref, lse_pref, o_t, lse_t)
    return o_pref.reshape(b, hq, d).to(q.dtype)
