"""GQA attention on the pooled serving cache (twin of the pooled half of
``repro.models.attention``)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.sparse_format import unpack
from repro_torch.core.sparse_kv import append_tail_panel, pooled_view
from repro_torch.kernels import ops
from .flash import full_attention
from .layers import apply_rope, rms_norm, rope_angles
from .module import ParamSpec


def attn_specs(cfg) -> Dict[str, ParamSpec]:
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


def pooled_attn_panel(p, x: torch.Tensor, kv: Dict[str, torch.Tensor], cfg,
                      positions: torch.Tensor, prefix_blocks: torch.Tensor,
                      tail_len: torch.Tensor, slot_mask: torch.Tensor,
                      bs: int, table: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """One ``[B, Qn]`` query panel per slot over one layer's pooled cache.

    The ``Qn`` fresh K/V land in each live slot's tail ring **in place**
    (``kv`` holds this layer's views of the pool storage); inactive slots
    write nothing.  Panel query ``j`` sees the frozen prefix, the existing
    tail and panel tokens ``<= j``.  ``table`` (int32 ``[B, Sb]``, paged
    pool only) switches the frozen prefix to the pool-global arena: ``kv``'s
    compressed leaves are then ``[n_phys, Hkv, X]`` and each slot reaches
    its blocks through its table row.  Returns the attention output
    projected by ``wo``, ``[B, Qn, d]``."""
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
