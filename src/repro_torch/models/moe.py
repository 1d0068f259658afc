"""Mixture-of-Experts layer (twin of ``repro.models.moe``): top-k routing,
capacity-based, sort-free dispatch.

Per top-k slot, each token's position in its expert's queue is an
exclusive cumsum over the ``[T, E]`` one-hot; tokens at positions below
the capacity are gathered into an ``[E, C, d]`` buffer, the experts run as
a stacked SwiGLU (``torch.bmm`` here, ``jnp.einsum`` there: the reference
computes it outside any Pallas kernel), and the results are added back
with their routing weights.  The semantics are the reference's
``moe_local``: an f32 router, ties to the lower expert id, the rounding
points, and tokens past an expert's capacity dropped.  Two differences of
form, not of result:

* the ``k`` slot passes share one expert product (each expert's ``k``
  buffers side by side, ``[E, k * C, d]``), so the expert weights are read
  once a call and not ``k`` times; a row's product depends on the size of
  the call, through cuBLAS's choice of a ``bmm`` kernel for the buffer's
  ``k * C`` rows (ROADMAP Queue 3, "MoE expert products across C");
* the dropping writes of ``mode="drop"`` go to a scratch column ``C`` of
  the index buffer, which is sliced away.

Every op is free of host syncs (no boolean-mask indexing, no ``.item()``,
no ``nonzero``), so the layer runs inside a captured CUDA graph.  A
padded prefill chunk passes its valid length as a device tensor: the
capacity comes from that length, as the reference's chunk of that length
computes it, and the padding rows (after the valid ones, so they never
move a valid row's queue position) are kept out of the buffers.

On a mesh (``ctx``; a rank's ``x`` is its data shard's rows, as
everywhere in the port) :func:`moe_apply` routes those rows alone, so the
capacity, and with it which tokens drop, follows the data shard, as the
reference's ``shard_map`` body calls ``moe_local`` per shard (ROADMAP
Queue 3, "per-shard MoE capacity"); where the model axis cut the experts'
``d_ff`` (a training placement), each rank runs its hidden units and the
outputs are summed over the model axis.  :func:`moe_apply_ep` puts the
experts over the data axes instead.  Both run under autograd.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_format import BlockSparseWeight, unpack
from repro_torch.distributed.sharding import (copy_to, gather_dim,
                                              mesh_axis_size, reduce_from,
                                              reduce_scatter, shard_index)
from .layers import mlp_apply, mlp_specs, tp_axes
from .module import ParamSpec


def moe_specs(cfg) -> Dict[str, ParamSpec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.pdtype
    specs = {
        "router": ParamSpec((d, e), torch.float32, ("embed", None)),
        "w_gate": ParamSpec((e, d, f), dt, ("experts", "embed", "ffn")),
        "w_up": ParamSpec((e, d, f), dt, ("experts", "embed", "ffn")),
        "w_down": ParamSpec((e, f, d), dt, ("experts", "ffn", "embed")),
    }
    if cfg.shared_expert:
        specs["shared"] = mlp_specs(cfg)
    return specs


def _expert_w(w, e: int) -> torch.Tensor:
    """Dense ``[E, K, N]`` view of a (possibly sparse) expert weight; a
    ``BlockSparseWeight`` stack is ``convert_to_sparse``'s ``[E*K, N]``
    fold."""
    if isinstance(w, BlockSparseWeight):
        dense = unpack(w)
        return dense.reshape(e, dense.shape[0] // e, dense.shape[1])
    return w


def _capacity(t: int, k: int, e: int, cf: float) -> int:
    c = int(-(-t * k * cf // e))
    return max(-(-c // 8) * 8, 8)


def _capacity_of(length: torch.Tensor, k: int, e: int,
                 cf: float) -> torch.Tensor:
    """:func:`_capacity` of a device length, on the device: the same
    float64 expression (``ceil(t * k * cf / e)``, exact for the configs'
    power-of-two expert counts), then rounded up to a multiple of 8."""
    c = torch.ceil(length.long().mul(k).to(torch.float64) * cf / e).long()
    return (torch.div(c + 7, 8, rounding_mode="floor") * 8).clamp(min=8)


@contextlib.contextmanager
def _exact_f32():
    """The router runs in f32 without TF32, whatever the process set."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def route(p, x: torch.Tensor, k: int):
    """``x [T, d]`` -> (``top_p [T, k]`` f32, renormalised; ``top_i [T, k]``
    int64), in descending order with ties to the lower expert id, the
    order ``lax.top_k`` guarantees."""
    with _exact_f32():
        logits = torch.matmul(x.to(torch.float32), p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_i = torch.sort(probs, dim=-1, descending=True,
                       stable=True).indices[:, :k]
    top_p = probs.gather(1, top_i)
    return top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9), top_i


def moe_local(p, x: torch.Tensor, cfg,
              length: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token dispatch + expert FFN on local tokens ``x [T, d]``.

    ``length`` (int64 ``[1]`` on the device, optional): only the first
    ``length`` rows are tokens, the rest padding; the capacity is that of
    ``length`` tokens, and the buffers are sized for ``T``."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = x.device
    c = _capacity(t, k, e, cfg.capacity_factor)
    row = torch.arange(t, device=dev)
    if length is None:
        bound, live = c, None
    else:
        bound = _capacity_of(length, k, e, cfg.capacity_factor)
        live = row < length
    top_p, top_i = route(p, x, k)
    experts = torch.arange(e, device=dev)
    bufs = []
    for slot in range(k):
        eid = top_i[:, slot]
        oh = (eid[:, None] == experts).to(torch.int64)          # [T, E]
        pos = (torch.cumsum(oh, 0) - oh).gather(1, eid[:, None])[:, 0]
        keep = pos < bound
        if live is not None:
            keep = keep & live
        # column c is the scratch column of the dropped writes
        buf = torch.full((e, c + 1), t, dtype=torch.int64, device=dev)
        buf.view(-1).scatter_(0, eid * (c + 1) + torch.where(keep, pos, c),
                              row)
        bufs.append(buf[:, :c])
    # one product for all k slots: expert e's k buffers side by side
    idx = torch.stack(bufs, 1).reshape(-1)                     # [E * k * C]
    x_pad = torch.cat([x, x.new_zeros((1, d))])
    xg = x_pad.index_select(0, idx).reshape(e, k * c, d)
    wg = _expert_w(p["w_gate"], e)
    wu = _expert_w(p["w_up"], e)
    wd = _expert_w(p["w_down"], e)
    h = (F.silu(torch.bmm(xg, wg)) * torch.bmm(xg, wu)).to(x.dtype)
    o = torch.bmm(h, wd).reshape(e, k, c, d)
    w_pad = torch.cat([top_p, top_p.new_zeros((1, k))])         # [T + 1, k]
    out = torch.zeros((t + 1, d), dtype=torch.float32, device=dev)
    for slot in range(k):
        b = bufs[slot].reshape(-1)
        wc = w_pad[:, slot].index_select(0, b)
        # a real row takes one value a slot: the sums are the reference's
        out.index_add_(0, b, o[:, slot].reshape(-1, d) * wc[:, None])
    return out[:t].to(x.dtype)


def moe_apply(p, x: torch.Tensor, cfg, ctx=None,
              length: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x [B, S, d]`` -> ``[B, S, d]``: every ``B * S`` row routed in row
    order, then Scout's shared expert added in ``x.dtype``.  ``length``:
    a padded chunk's valid rows (``B == 1``), as :func:`moe_local`.

    On a mesh ``ctx``: ``cfg.ep_moe`` takes :func:`moe_apply_ep` where the
    experts divide the data axes; else the rows are routed here (this
    data shard's capacity) and, where the model axis cut ``d_ff``, the
    router's and ``x``'s gradients are summed over it and so is the
    output."""
    b, s, d = x.shape
    if getattr(ctx, "mesh", None) is not None and cfg.ep_moe:
        out = moe_apply_ep(p, x, cfg, ctx)
        if out is not None:
            return out
    tp = tp_axes(ctx) if p["w_gate"].shape[-1] < cfg.d_ff else ()
    if not tp:
        out = moe_local(p, x.reshape(-1, d), cfg, length).reshape(b, s, d)
        if cfg.shared_expert:
            out = out + mlp_apply(p["shared"], x)
        return out
    mesh = ctx.mesh
    x = copy_to(x, mesh, tp)
    out = moe_local({**p, "router": copy_to(p["router"], mesh, tp)},
                    x.reshape(-1, d), cfg, length).reshape(b, s, d)
    if cfg.shared_expert:                # this rank's units, summed below
        out = out + mlp_apply(p["shared"], x)
    return reduce_from(out, mesh, tp)


def moe_apply_ep(p, x: torch.Tensor, cfg, ctx) -> Optional[torch.Tensor]:
    """Expert-parallel MoE: the experts split over the data axes (``E /
    ep`` a data rank; ``w_*`` either already this rank's experts, the
    training placement under ``cfg.ep_moe``, or all of them, sliced here),
    ``d_ff`` over the model axis where it is cut.  The tokens of every
    data rank are gathered, routed (the capacity of all of them, as one
    rank's ``moe_local`` on the whole batch), each rank computes its
    experts' contributions and the shared expert on data index 0 only,
    and the f32 sum over the model axis is reduce-scattered back to each
    data rank's rows.  Returns None where the data axes do not divide the
    experts (the caller takes the tensor-parallel path), as the reference
    does."""
    mesh = ctx.mesh
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    dp = ctx.mesh_axes("batch")
    ep = mesh_axis_size(mesh, dp)
    if ep <= 1 or e % ep != 0:
        return None
    e_loc = e // ep
    idx = shard_index(mesh, dp)
    e0 = idx * e_loc
    w = {key: p[key][e0:e0 + e_loc] if p[key].shape[0] == e else p[key]
         for key in ("w_gate", "w_up", "w_down")}
    tp = tp_axes(ctx) if w["w_gate"].shape[-1] < cfg.d_ff else ()
    xa = copy_to(gather_dim(x, mesh, dp, 0), mesh, dp + tp)
    tok = xa.reshape(-1, d)
    t = tok.shape[0]
    dev = x.device
    c = _capacity(t, k, e, cfg.capacity_factor)
    top_p, top_i = route({"router": copy_to(p["router"], mesh, tp)}, tok, k)
    row = torch.arange(t, device=dev)
    experts = torch.arange(e_loc, device=dev)
    bufs = []
    for slot in range(k):
        eid = top_i[:, slot]
        mine = (eid >= e0) & (eid < e0 + e_loc)
        # this rank's expert id; e_loc for another rank's
        le = torch.where(mine, eid - e0, e_loc)
        oh = (le[:, None] == experts).to(torch.int64)
        pos = (torch.cumsum(oh, 0) - oh).gather(
            1, le.clamp(max=e_loc - 1)[:, None])[:, 0]
        keep = mine & (pos < c)
        # row e_loc and column c take the writes of other ranks' and
        # dropped tokens
        buf = torch.full((e_loc + 1, c + 1), t, dtype=torch.int64,
                         device=dev)
        buf.view(-1).scatter_(0, le * (c + 1) + torch.where(keep, pos, c),
                              row)
        bufs.append(buf[:e_loc, :c])
    ids = torch.stack(bufs, 1).reshape(-1)
    x_pad = torch.cat([tok, tok.new_zeros((1, d))])
    xg = x_pad.index_select(0, ids).reshape(e_loc, k * c, d)
    h = (F.silu(torch.bmm(xg, w["w_gate"])) * torch.bmm(xg, w["w_up"])
         ).to(x.dtype)
    o = torch.bmm(h, w["w_down"]).reshape(e_loc, k, c, d)
    w_pad = torch.cat([top_p, top_p.new_zeros((1, k))])
    out = torch.zeros((t + 1, d), dtype=torch.float32, device=dev)
    for slot in range(k):
        ib = bufs[slot].reshape(-1)
        wc = w_pad[:, slot].index_select(0, ib)
        out = out.index_add(0, ib, o[:, slot].reshape(-1, d).float()
                            * wc[:, None])
    out = out[:t]
    if cfg.shared_expert and idx == 0:
        out = out + mlp_apply(p["shared"], tok).float()
    out = reduce_from(out.reshape(-1, s, d), mesh, tp)
    return reduce_scatter(out, mesh, dp, 0).to(x.dtype)
