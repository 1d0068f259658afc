"""GQA attention (twin of ``repro.models.attention``): the full-sequence
prefill (self-attention, or an encoder-decoder's cross attention over the
encoder's memory), the one-token decode over the legacy dense or sparse KV
cache and its cross attention over the encoder's dense K/V, and the panel
and chunk attention of the pooled serving cache.  Sequences longer than
``cfg.full_attn_max`` take the blocked attention, as in the reference."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.sparse_format import unpack
from repro_torch.core.sparse_kv import (NAN_CHECK, SparseKVCache,
                                         append_tail_panel, append_token,
                                         flag_, pooled_view)
from repro_torch.kernels import ops
from .flash import blocked_attention, full_attention
from .layers import apply_rope, rms_norm, rope_angles
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


def _project_q(p, x, cfg):
    b = x.shape[:-1]
    q = ops.linear(x, p["wq"]).reshape(*b, cfg.padded_heads, cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    return q


def _project_kv(p, x, cfg):
    b = x.shape[:-1]
    k = ops.linear(x, p["wk"]).reshape(*b, cfg.n_kv, cfg.hd)
    v = ops.linear(x, p["wv"]).reshape(*b, cfg.n_kv, cfg.hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    return k, v


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
               return_kv: bool = False):
    """Attention of ``x [B, S, d]`` at ``positions [S]``: self-attention,
    or, given ``memory [B, Sm, d]`` (an encoder-decoder's encoder output),
    cross attention whose K/V are projected from the memory.  As in the
    reference, RoPE applies to neither side under ``memory``, and
    ``causal=None`` means causal exactly when there is no memory.  With
    ``return_kv`` also the (post-RoPE) ``(k, v)`` ``[B, Hkv, Sm, hd]`` for
    the cache.  Up to ``cfg.full_attn_max`` tokens on both sides run as
    one unblocked attention, longer sequences as the blocked attention in
    the ``attn_impl`` schedule, as in the reference."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.padded_heads, cfg.n_kv, cfg.hd
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
    thr = getattr(cfg, "full_attn_max", 4096)
    g = hq // hkv
    sm = 1.0 / hd ** 0.5
    if s <= thr and k.shape[2] <= thr:
        o = full_attention(q, _repeat_kv(k, g), _repeat_kv(v, g), sm,
                           causal=causal)
    else:
        o = blocked_attention(q, _repeat_kv(k, g), _repeat_kv(v, g), sm,
                              causal=causal, impl=attn_impl)
    out = ops.linear(o.transpose(1, 2).reshape(b, s, hq * hd), p["wo"])
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# decode (one token over the legacy cache)
# ---------------------------------------------------------------------------

def attn_decode(p, x_t: torch.Tensor, cache: Any, cfg,
                position: torch.Tensor) -> Tuple[torch.Tensor, Any]:
    """One new token ``x_t [B, d]`` at ``position`` (an int32 scalar on the
    device) over a :class:`DenseKVCache` or
    :class:`~repro_torch.core.sparse_kv.SparseKVCache`.  The token's K/V
    are written into the cache **in place** and the cache is returned.
    The sparse cache runs the fused prefix + tail kernel
    (``ops.sparse_decode_attention``); the dense cache is plain PyTorch, as
    the reference's is plain ``jnp``."""
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
        o = ops.sparse_decode_attention(q, cache.k_sp, cache.v_sp, hkv, sm,
                                        cache.k_tail, cache.v_tail,
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
                      err: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One ``[B, Qn]`` query panel per slot over one layer's pooled cache.

    The ``Qn`` fresh K/V land in each live slot's tail ring **in place**
    (``kv`` holds this layer's views of the pool storage); inactive slots
    write nothing.  Panel query ``j`` sees the frozen prefix, the existing
    tail and panel tokens ``<= j``.  ``table`` (int32 ``[B, Sb]``, paged
    pool only) switches the frozen prefix to the pool-global arena: ``kv``'s
    compressed leaves are then ``[n_phys, Hkv, X]`` and each slot reaches
    its blocks through its table row.  ``err`` (the sanitized pool's error
    word) gets the NaN bit where a live slot appends a NaN.  Returns the
    attention output projected by ``wo``, ``[B, Qn, d]``."""
    b, qn, _ = x.shape
    hq, hkv, hd = cfg.padded_heads, cfg.n_kv, cfg.hd
    q = _project_q(p, x, cfg)                                 # [B,Qn,Hq,hd]
    k_new, v_new = _project_kv(p, x, cfg)                     # [B,Qn,Hkv,hd]
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)     # [B,Qn,hd//2]
    q = apply_rope(q, cos, sin)
    k_new = apply_rope(k_new, cos, sin)
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
    return ops.linear(o.reshape(b, qn, hq * hd).to(x.dtype), p["wo"])


def pooled_attn_prefill_chunk(p, x: torch.Tensor,
                              kv: Dict[str, torch.Tensor], cfg,
                              positions: torch.Tensor, ctx_len: torch.Tensor,
                              bs: int, slot: torch.Tensor,
                              table_row: Optional[torch.Tensor] = None
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
    to freeze."""
    b, c, _ = x.shape
    hq, hkv, hd = cfg.padded_heads, cfg.n_kv, cfg.hd
    g = hq // hkv
    q = _project_q(p, x, cfg)                                # [1,C,Hq,hd]
    k, v = _project_kv(p, x, cfg)                            # [1,C,Hkv,hd]
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)    # [C, hd//2]
    q = apply_rope(q, cos[None], sin[None]).transpose(1, 2)  # [1,Hq,C,hd]
    k = apply_rope(k, cos[None], sin[None]).transpose(1, 2)  # [1,Hkv,C,hd]
    v = v.transpose(1, 2)

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
            b, hq, *a.shape[2:])
    kk = per_query_head(torch.cat([k_ctx.to(k.dtype), k], dim=2))
    vv = per_query_head(torch.cat([v_ctx.to(v.dtype), v], dim=2))
    o = full_attention(q, kk, vv, 1.0 / hd ** 0.5, causal=True,
                       kv_valid=kv_valid)
    o = o.transpose(1, 2).reshape(b, c, hq * hd)
    return ops.linear(o, p["wo"]), k, v
