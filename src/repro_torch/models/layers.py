"""Shared model components: RMSNorm, RoPE, embeddings, SwiGLU MLP (twin of
``repro.models.layers``).  Norm and RoPE compute in f32 and cast back.

Under a training ``ctx`` (a ``ShardCtx`` whose model axis cuts the params,
``distributed/sharding.py``) the embedding table and the head are
vocab-parallel and the MLP is column-parallel into ``w_gate`` / ``w_up``
and row-parallel out of ``w_down``; a leaf whose dim does not divide the
axis stays whole, and its layer runs as on one rank.  The residual stream
stays replicated over the model axis."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import copy_to, reduce_from
from repro_torch.kernels import ops
from .module import ParamSpec


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, as the reference computes it, except that the f32
    squares are summed in f64 before the mean rounds to f32.  On the card
    torch sums a row in an order that depends on how many rows share the
    call, so an f32 sum could move by an ulp between a decode tick (B rows)
    and a speculative verify panel (B * (k+1) rows); in f64 the sum of the
    squares of bf16 (or f32) activations is exact, or all but exact, in any
    order, and a verify row equals the decode tick of the same token bit
    for bit."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True,
                     dtype=torch.float64).float()
    return (xf * torch.rsqrt(var + eps)
            * scale.to(torch.float32)).to(x.dtype)


def rope_angles(positions: torch.Tensor, hd: int, theta: float):
    """positions [...] -> (cos, sin) of shape [..., hd//2] (f32)."""
    dev = positions.device
    freq = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=dev) / hd))
    ang = positions.to(torch.float32)[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, D] with cos/sin [..., S, D//2] (broadcast over H)."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


def embed_specs(cfg) -> Dict[str, ParamSpec]:
    d = cfg.pdtype
    specs = {"tok": ParamSpec((cfg.vocab, cfg.d_model), d,
                              ("vocab", "embed"), init="embed")}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab), d,
                                     ("embed", "vocab"))
    return specs


def tp_axes(ctx):
    """The model axes of a mesh ``ctx`` that a tensor-parallel layer's
    collectives cross (``()`` without a mesh or at model size 1)."""
    return () if ctx is None else ctx.mesh_axes("ffn")


def vocab_shard(ctx, table_rows: int, cfg):
    """``(first row, rows)`` of this rank's block of the vocabulary when
    the model axis cuts a table of ``table_rows`` rows out of
    ``cfg.vocab``, else None."""
    if not tp_axes(ctx) or table_rows == cfg.vocab:
        return None
    return ctx.shard_range("vocab", cfg.vocab)


def embed_apply(p, tokens: torch.Tensor, cfg, ctx=None) -> torch.Tensor:
    """The table's rows of ``tokens``; vocab-parallel under ``ctx``: a
    token outside this rank's rows looks up zero, and the ranks' lookups
    are summed over the model axis."""
    tok = p["tok"]
    shard = vocab_shard(ctx, tok.shape[0], cfg)
    if shard is None:
        return F.embedding(tokens, tok).to(cfg.cdtype)
    v0, n = shard
    local = tokens - v0
    mine = (local >= 0) & (local < n)
    e = F.embedding(local.clamp(0, n - 1), tok) * mine[..., None].to(
        tok.dtype)
    return reduce_from(e, ctx.mesh, tp_axes(ctx)).to(cfg.cdtype)


def unembed_apply(p, x: torch.Tensor, cfg, ctx=None) -> torch.Tensor:
    """f32 logits; under ``ctx`` with the head cut over the model axis,
    this rank's vocabulary columns (``vocab_shard``)."""
    # tied: tok.T is a view, so the dense kernel reads tok's rows in place
    w = p["tok"].T.to(cfg.cdtype) if cfg.tie_embeddings else p["lm_head"]
    if vocab_shard(ctx, w.shape[-1], cfg) is not None:
        x = copy_to(x, ctx.mesh, tp_axes(ctx))
    return ops.linear(x, w, out_dtype=torch.float32)


def mlp_specs(cfg, d_in: Optional[int] = None,
              d_ff: Optional[int] = None) -> Dict[str, ParamSpec]:
    d_in = d_in or cfg.d_model
    d_ff = d_ff or cfg.d_ff
    dt = cfg.pdtype
    return {
        "w_gate": ParamSpec((d_in, d_ff), dt, ("embed", "ffn")),
        "w_up": ParamSpec((d_in, d_ff), dt, ("embed", "ffn")),
        "w_down": ParamSpec((d_ff, d_in), dt, ("ffn", "embed")),
    }


def mlp_apply(p, x: torch.Tensor, rows=None, ctx=None,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """SwiGLU; under ``ctx``, where the model axis cut the ``d_ff`` hidden
    units, this rank's units and the sum over the model axis."""
    tp = tp_axes(ctx) if d_ff and p["w_gate"].shape[-1] < d_ff else ()
    if tp:
        x = copy_to(x, ctx.mesh, tp)
    h = F.silu(ops.linear(x, p["w_gate"], rows=rows)) * \
        ops.linear(x, p["w_up"], rows=rows)
    out = ops.linear(h, p["w_down"], rows=rows)
    return reduce_from(out, ctx.mesh, tp) if tp else out


def norm_spec(cfg, d: Optional[int] = None) -> ParamSpec:
    return ParamSpec((d or cfg.d_model,), torch.float32, ("embed",),
                     init="ones")
