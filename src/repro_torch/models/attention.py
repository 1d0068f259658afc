"""GQA attention (twin of ``repro.models.attention``): the full-sequence
prefill (self-attention, or an encoder-decoder's cross attention over the
encoder's memory), the one-token decode over the legacy dense or sparse KV
cache and its cross attention over the encoder's dense K/V, and the panel
and chunk attention of the pooled serving cache.  Sequences longer than
``cfg.full_attn_max`` take the blocked attention, as in the reference.

The training forward's self-attention runs tensor-parallel under a
training ``ctx`` (:func:`attn_apply`): each rank projects its columns of
``wq`` / ``wk`` / ``wv`` and ``wo`` is row-parallel, then a sum over the
model axis.  Where a rank's columns are not whole heads with their GQA
groups, the projections are gathered over the model axis first and every
rank attends over every head (ROADMAP Queue 3, "heads cut mid-way")."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.sparse_format import unpack
from repro_torch.distributed.cp_attention import sparse_decode_attention_cp
from repro_torch.distributed.sharding import (all_gather, copy_to,
                                             gather_dim, reduce_from)
from repro_torch.core.sparse_kv import (NAN_CHECK, SparseKVCache,
                                         append_tail_panel, append_token,
                                         flag_, pooled_view)
from repro_torch.kernels import ops
from .flash import blocked_attention, full_attention
from .layers import apply_rope, rms_norm, rope_angles, tp_axes
from .module import ParamSpec


# ---------------------------------------------------------------------------
# the legacy dense cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DenseKVCache:
    """Baseline decode cache: preallocated ``[B, Hkv, S_max, D]`` and an
    int32 scalar length (optionally stacked over periods, sliced by
    :meth:`layer`)."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    def layer(self, i: int) -> "DenseKVCache":
        return DenseKVCache(self.k[i], self.v[i], self.length[i])


def init_dense_cache(batch, hkv, s_max, d, dtype=torch.bfloat16,
                     device="cpu") -> DenseKVCache:
    z = lambda: torch.zeros((batch, hkv, s_max, d), dtype=dtype,
                            device=device)
    return DenseKVCache(z(), z(), torch.zeros((), dtype=torch.int32,
                                              device=device))


def attn_specs(cfg, cross: bool = False) -> Dict[str, ParamSpec]:
    """Self- or (``cross``) cross-attention weights: the same leaves, as in
    the reference."""
    hq, hkv, hd, d = cfg.padded_heads, cfg.n_kv, cfg.hd, cfg.d_model
    dt = cfg.pdtype
    specs = {
        "wq": ParamSpec((d, hq * hd), dt, ("embed", "heads")),
        "wk": ParamSpec((d, hkv * hd), dt, ("embed", "kv_heads")),
        "wv": ParamSpec((d, hkv * hd), dt, ("embed", "kv_heads")),
        "wo": ParamSpec((hq * hd, d), dt, ("heads", "embed")),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), torch.float32, (None,),
                                    init="ones")
        specs["k_norm"] = ParamSpec((hd,), torch.float32, (None,),
                                    init="ones")
    return specs


def _project_q(p, x, cfg, rows=None):
    b = x.shape[:-1]
    q = ops.linear(x, p["wq"], rows=rows).reshape(*b, cfg.padded_heads,
                                                  cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    return q


def _project_kv(p, x, cfg, rows=None):
    b = x.shape[:-1]
    k = ops.linear(x, p["wk"], rows=rows).reshape(*b, cfg.n_kv, cfg.hd)
    v = ops.linear(x, p["wv"], rows=rows).reshape(*b, cfg.n_kv, cfg.hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    return k, v


def _head_shard(ctx, cfg) -> Tuple[int, int]:
    """``(first KV head, KV heads)`` this rank attends over: its model
    shard of the KV heads on a mesh (all of them where they replicate),
    every head without one."""
    if ctx is None or ctx.mesh is None:
        return 0, cfg.n_kv
    return ctx.shard_range("kv_heads", cfg.n_kv)


def _local_heads(ctx, cfg, q, k, v, dim: int):
    """q ``[..., Hq, hd]`` and k, v ``[..., Hkv, hd]`` (heads at ``dim``)
    cut to this rank's KV heads and their query groups; returns them and
    the local KV head count."""
    h0, hl = _head_shard(ctx, cfg)
    if hl == cfg.n_kv:
        return q, k, v, hl
    g = cfg.padded_heads // cfg.n_kv
    return (q.narrow(dim, h0 * g, hl * g).contiguous(),
            k.narrow(dim, h0, hl).contiguous(),
            v.narrow(dim, h0, hl).contiguous(), hl)


def _gather_heads(ctx, cfg, o: torch.Tensor, dim: int) -> torch.Tensor:
    """Every model rank's head outputs, concatenated in head order along
    ``dim`` (``o`` itself where the heads replicate)."""
    if ctx is None or ctx.mesh is None:
        return o
    axis = ctx.spec(("kv_heads",), (cfg.n_kv,))[0]
    return all_gather(o, ctx.mesh, axis, dim)


def _repeat_kv(k: torch.Tensor, g: int) -> torch.Tensor:
    """``[B, Hkv, S, D]`` -> ``[B, Hkv * g, S, D]`` (prefill and the dense
    decode only; the decode kernels expand the groups in registers)."""
    return torch.repeat_interleave(k, g, dim=1)


# ---------------------------------------------------------------------------
# full sequence (prefill)
# ---------------------------------------------------------------------------

def attn_apply(p, x: torch.Tensor, cfg, positions: torch.Tensor,
               memory: Optional[torch.Tensor] = None,
               causal: Optional[bool] = None, attn_impl: str = "masked",
               return_kv: bool = False, ctx=None):
    """Attention of ``x [B, S, d]`` at ``positions [S]``: self-attention,
    or, given ``memory [B, Sm, d]`` (an encoder-decoder's encoder output),
    cross attention whose K/V are projected from the memory.  As in the
    reference, RoPE applies to neither side under ``memory``, and
    ``causal=None`` means causal exactly when there is no memory.  With
    ``return_kv`` also the (post-RoPE) ``(k, v)`` ``[B, Hkv, Sm, hd]`` for
    the cache.  Up to ``cfg.full_attn_max`` tokens on both sides run as
    one unblocked attention, longer sequences as the blocked attention in
    the ``attn_impl`` schedule, as in the reference.  Under a training
    ``ctx`` whose model axis cut ``wo``, self-attention runs
    tensor-parallel (:func:`_attn_tp`)."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.padded_heads, cfg.n_kv, cfg.hd
    if memory is None and tp_axes(ctx) and p["wo"].shape[0] < hq * hd:
        if return_kv:
            raise ValueError("a tensor-parallel attention keeps no KV cache")
        return _attn_tp(p, x, cfg, positions, ctx, attn_impl)
    q = _project_q(p, x, cfg)                                # [B,S,Hq,hd]
    k, v = _project_kv(p, x if memory is None else memory,
                       cfg)                                  # [B,Sm,Hkv,hd]
    if causal is None:
        causal = memory is None
    if memory is None:
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    o = _sdpa(q, k, v, cfg, causal, attn_impl)
    out = ops.linear(o.transpose(1, 2).reshape(b, s, hq * hd), p["wo"])
    if return_kv:
        return out, (k, v)
    return out


def _sdpa(q, k, v, cfg, causal, attn_impl):
    """``q [B, Hq, S, hd]`` over ``k``, ``v`` ``[B, Hkv, Sm, hd]`` (GQA),
    unblocked up to ``cfg.full_attn_max`` tokens, else blocked."""
    g = q.shape[1] // k.shape[1]
    sm = 1.0 / cfg.hd ** 0.5
    thr = getattr(cfg, "full_attn_max", 4096)
    if q.shape[2] <= thr and k.shape[2] <= thr:
        return full_attention(q, _repeat_kv(k, g), _repeat_kv(v, g), sm,
                              causal=causal)
    return blocked_attention(q, _repeat_kv(k, g), _repeat_kv(v, g), sm,
                             causal=causal, impl=attn_impl)


def _attn_tp(p, x, cfg, positions, ctx, attn_impl):
    """Causal self-attention of ``x [B, S, d]`` with ``wo`` cut over the
    model axis (row-parallel) and ``wq`` / ``wk`` / ``wv`` cut or whole:
    each rank's share of ``out``, summed over the model axis.

    Aligned (every projection cut into whole heads, the KV heads' GQA
    groups on the same rank): a rank attends over its own heads.  Else
    each cut projection is gathered over the model axis (its gradient
    summed over it before the slice is taken) and every rank attends over
    every head, then keeps the heads of its ``wo`` rows.  ``q_norm`` /
    ``k_norm`` act on a rank's heads only, so their gradient is summed
    over the model axis."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.padded_heads, cfg.n_kv, cfg.hd
    mesh, tp = ctx.mesh, tp_axes(ctx)
    n = hq * hd // p["wo"].shape[0]                      # model shards
    x = copy_to(x, mesh, tp)
    widths = {"wq": hq * hd, "wk": hkv * hd, "wv": hkv * hd}
    cut = {key: p[key].shape[-1] < full for key, full in widths.items()}
    aligned = all(cut.values()) and hq % n == 0 and hkv % n == 0
    norm = {key: copy_to(p[key], mesh, tp)
            for key in ("q_norm", "k_norm") if key in p}

    def project(key):
        if not cut[key]:            # a whole weight used for part of out
            return ops.linear(x, copy_to(p[key], mesh, tp)).reshape(
                b, s, -1, hd)
        y = ops.linear(x, p[key])
        if not aligned:
            y = copy_to(gather_dim(y, mesh, tp, -1), mesh, tp)
        return y.reshape(b, s, -1, hd)

    q, k, v = project("wq"), project("wk"), project("wv")
    if cfg.qk_norm:
        q = rms_norm(q, norm["q_norm"])
        k = rms_norm(k, norm["k_norm"])
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    o = _sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), cfg,
              True, attn_impl).transpose(1, 2)           # [B, S, H, hd]
    o = o.reshape(b, s, -1)
    if not aligned:                    # this rank's rows of wo: its heads
        r0, rn = ctx.shard_range("heads", hq * hd)
        o = o[..., r0:r0 + rn]
    return reduce_from(ops.linear(o, p["wo"]), mesh, tp)


# ---------------------------------------------------------------------------
# decode (one token over the legacy cache)
# ---------------------------------------------------------------------------

def attn_decode(p, x_t: torch.Tensor, cache: Any, cfg,
                position: torch.Tensor, ctx=None
                ) -> Tuple[torch.Tensor, Any]:
    """One new token ``x_t [B, d]`` at ``position`` (an int32 scalar on the
    device) over a :class:`DenseKVCache` or
    :class:`~repro_torch.core.sparse_kv.SparseKVCache`.  The token's K/V
    are written into the cache **in place** and the cache is returned.
    The sparse cache runs the fused prefix + tail kernel
    (``ops.sparse_decode_attention``); the dense cache is plain PyTorch, as
    the reference's is plain ``jnp``.  Under ``cfg.cp_decode`` with a
    mesh ``ctx`` the structured sparse cache takes the context-parallel
    path (``distributed/cp_attention.py``), as the reference's does."""
    b, _ = x_t.shape
    hq, hkv, hd = cfg.padded_heads, cfg.n_kv, cfg.hd
    q = _project_q(p, x_t, cfg)                              # [B,Hq,hd]
    k_new, v_new = _project_kv(p, x_t, cfg)                  # [B,Hkv,hd]
    cos, sin = rope_angles(position, hd, cfg.rope_theta)     # [hd//2]
    q = apply_rope(q[:, None], cos[None, None], sin[None, None])[:, 0]
    k_new = apply_rope(k_new[:, None], cos[None, None], sin[None, None])[:, 0]
    sm = 1.0 / hd ** 0.5
    if isinstance(cache, SparseKVCache):
        append_token(cache, k_new, v_new)
        if (cfg.cp_decode and ctx is not None and ctx.mesh is not None
                and cache.k_sp.bitmap.dim() == 5):
            o = sparse_decode_attention_cp(q, cache, hkv, sm, ctx)
        else:
            o = ops.sparse_decode_attention(q, cache.k_sp, cache.v_sp, hkv,
                                            sm, cache.k_tail, cache.v_tail,
                                            cache.tail_len)
    else:
        idx = cache.length.long().reshape(1)
        cache.k.index_copy_(2, idx, k_new[:, :, None].to(cache.k.dtype))
        cache.v.index_copy_(2, idx, v_new[:, :, None].to(cache.v.dtype))
        cache.length += 1
        valid = torch.arange(cache.k.shape[2], device=x_t.device) \
            < cache.length
        g = hq // hkv
        o = full_attention(q[:, :, None], _repeat_kv(cache.k, g),
                           _repeat_kv(cache.v, g), sm, causal=False,
                           kv_valid=valid.expand(b, -1))[:, :, 0]
    out = ops.linear(o.reshape(b, hq * hd).to(x_t.dtype), p["wo"])
    return out, cache


def cross_attn_decode(p, x_t: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, cfg) -> torch.Tensor:
    """Decode-time cross attention of ``x_t [B, d]`` against the encoder's
    precomputed dense K/V ``[B, Hkv, Sm, hd]``: no mask, no RoPE, no cache
    update; plain PyTorch, as the reference's is plain ``jnp``."""
    b, _ = x_t.shape
    hq, hkv, hd = cfg.padded_heads, cfg.n_kv, cfg.hd
    q = _project_q(p, x_t, cfg)
    g = hq // hkv
    o = full_attention(q[:, :, None, :], _repeat_kv(k, g), _repeat_kv(v, g),
                       1.0 / hd ** 0.5, causal=False)[:, :, 0, :]
    return ops.linear(o.reshape(b, hq * hd).to(x_t.dtype), p["wo"])


# ---------------------------------------------------------------------------
# the pooled serving cache
# ---------------------------------------------------------------------------

def pooled_attn_panel(p, x: torch.Tensor, kv: Dict[str, torch.Tensor], cfg,
                      positions: torch.Tensor, prefix_blocks: torch.Tensor,
                      tail_len: torch.Tensor, slot_mask: torch.Tensor,
                      bs: int, table: Optional[torch.Tensor] = None,
                      err: Optional[torch.Tensor] = None,
                      ctx=None, rows: Optional[int] = None) -> torch.Tensor:
    """One ``[B, Qn]`` query panel per slot over one layer's pooled cache.

    The ``Qn`` fresh K/V land in each live slot's tail ring **in place**
    (``kv`` holds this layer's views of the pool storage); inactive slots
    write nothing.  Panel query ``j`` sees the frozen prefix, the existing
    tail and panel tokens ``<= j``.  ``table`` (int32 ``[B, Sb]``, paged
    pool only) switches the frozen prefix to the pool-global arena: ``kv``'s
    compressed leaves are then ``[n_phys, Hkv, X]`` and each slot reaches
    its blocks through its table row.  ``err`` (the sanitized pool's error
    word) gets the NaN bit where a live slot appends a NaN.  Returns the
    attention output projected by ``wo``, ``[B, Qn, d]``.

    On a mesh (``ctx``) the rows are this rank's slots and ``kv`` holds its
    KV heads: q/k/v run on the replicated weights as without one, the rank
    keeps its heads and their query groups, attends over them, and the
    head outputs are all-gathered over the model axis, in head order,
    before ``wo``.  ``rows``: the whole panel's rows, which pick the sparse
    linears' kernel (``ops.sparse_matmul``)."""
    b, qn, _ = x.shape
    hq, hd = cfg.padded_heads, cfg.hd
    q = _project_q(p, x, cfg, rows)                           # [B,Qn,Hq,hd]
    k_new, v_new = _project_kv(p, x, cfg, rows)               # [B,Qn,Hkv,hd]
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)     # [B,Qn,hd//2]
    q = apply_rope(q, cos, sin)
    k_new = apply_rope(k_new, cos, sin)
    q, k_new, v_new, hkv = _local_heads(ctx, cfg, q, k_new, v_new, 2)
    sm = 1.0 / hd ** 0.5

    live = slot_mask.to(torch.int32)
    n_valid = live * qn
    if err is not None:
        nan = torch.isnan(k_new).flatten(1).any(1) | \
            torch.isnan(v_new).flatten(1).any(1)
        flag_(err, nan & slot_mask, NAN_CHECK)
    append_tail_panel(kv["k_tail"], k_new.transpose(1, 2), tail_len, n_valid)
    append_tail_panel(kv["v_tail"], v_new.transpose(1, 2), tail_len, n_valid)
    # panel query 0 sees its own token; each later query j sees j more
    t_att = tail_len + live
    if table is not None:
        o = ops.sparse_decode_attention_paged(
            q, kv["k_bitmap"], kv["k_values"], kv["v_bitmap"],
            kv["v_values"], table, hkv, sm, bs, kv["k_tail"], kv["v_tail"],
            t_att, prefix_len=prefix_blocks * bs)
    else:
        k_sp = pooled_view(kv["k_bitmap"], kv["k_values"], bs, hd)
        v_sp = pooled_view(kv["v_bitmap"], kv["v_values"], bs, hd)
        o = ops.sparse_decode_attention(q, k_sp, v_sp, hkv, sm,
                                        kv["k_tail"], kv["v_tail"], t_att,
                                        prefix_len=prefix_blocks * bs)
    o = _gather_heads(ctx, cfg, o, 2)
    return ops.linear(o.reshape(b, qn, hq * hd).to(x.dtype), p["wo"],
                      rows=rows)


def pooled_attn_prefill_chunk(p, x: torch.Tensor,
                              kv: Dict[str, torch.Tensor], cfg,
                              positions: torch.Tensor, ctx_len: torch.Tensor,
                              bs: int, slot: torch.Tensor,
                              table_row: Optional[torch.Tensor] = None,
                              ctx=None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Chunked-prefill attention for ONE slot: causal within the chunk plus
    full attention over the slot's valid frozen prefix (decompressed here;
    the chunk path is off the per-token loop).  ``x [1, C, d]``; ``kv`` one
    layer's compressed leaves ``[B, Hkv, Sb, X]``, of which ``slot`` (int64
    ``[1]`` on the device, so one capture serves every slot) picks the
    slot's with ``index_select``, or with ``table_row`` (int32 ``[Sb]``,
    paged pool only) the shared arena ``[n_phys, Hkv, X]``, from which the
    slot's prefix is gathered through its table row (a prefix-cache hit
    means these are blocks another request froze).  Causal masking keeps
    any padding rows behind the valid ones unseen by them.  Returns ``(out
    [1, C, d], k_chunk, v_chunk [1, Hkv, C, hd])`` post-RoPE for the caller
    to freeze.  On a mesh (``ctx``) the rank attends over its KV heads
    (``kv`` holds them) and their query groups, returns its heads' chunk
    K/V, and gathers the head outputs over the model axis before ``wo``,
    as :func:`pooled_attn_panel` does."""
    b, c, _ = x.shape
    hq, hd = cfg.padded_heads, cfg.hd
    q = _project_q(p, x, cfg)                                # [1,C,Hq,hd]
    k, v = _project_kv(p, x, cfg)                            # [1,C,Hkv,hd]
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)    # [C, hd//2]
    q = apply_rope(q, cos[None], sin[None])
    k = apply_rope(k, cos[None], sin[None])
    q, k, v, hkv = _local_heads(ctx, cfg, q, k, v, 2)
    hql, g = q.shape[2], q.shape[2] // hkv
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    keys = ("k_bitmap", "k_values", "v_bitmap", "v_values")
    if table_row is not None:
        # entries are in range by construction; clamped as the reference's
        # explicit clip-mode gather
        idx = table_row.long().clamp(0, kv["k_bitmap"].shape[0] - 1)
        comp = {k: kv[k][idx].transpose(0, 1)[None] for k in keys}
    else:
        comp = {k: kv[k].index_select(0, slot) for k in keys}
    k_ctx = unpack(pooled_view(comp["k_bitmap"], comp["k_values"], bs, hd))
    v_ctx = unpack(pooled_view(comp["v_bitmap"], comp["v_values"], bs, hd))
    s_ctx = k_ctx.shape[2]
    dev = x.device
    kv_valid = torch.cat([torch.arange(s_ctx, device=dev) < ctx_len,
                          torch.ones(c, dtype=torch.bool, device=dev)])[None]
    def per_query_head(a):              # [1, Hkv, S, hd] -> [1, Hq, S, hd]
        return a[:, :, None].expand(b, hkv, g, *a.shape[2:]).reshape(
            b, hql, *a.shape[2:])
    kk = per_query_head(torch.cat([k_ctx.to(k.dtype), k], dim=2))
    vv = per_query_head(torch.cat([v_ctx.to(v.dtype), v], dim=2))
    o = full_attention(q, kk, vv, 1.0 / hd ** 0.5, causal=True,
                       kv_valid=kv_valid)
    o = _gather_heads(ctx, cfg, o, 1)
    o = o.transpose(1, 2).reshape(b, c, hq * hd)
    return ops.linear(o, p["wo"]), k, v
