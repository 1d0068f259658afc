"""The train step (twin of ``repro.train.step``): the chunked loss, the
gradients, microbatch accumulation and AdamW, and the compressed-gradient
step.

The loss computes the logits a chunk of positions at a time, so the
``[B, S, V]`` tensor never exists.  Gradients come from ``torch.autograd``
through :func:`repro_torch.models.lm.forward_train`: on the card every
dense linear and the tied head run the hand-written dense kernel in the
forward and in the remat replay (``kernels/dense_matmul.py::
DenseMatmulGrad``), and ``torch.matmul`` in the backward, as XLA
transposes the reference's ``jnp.dot``.

**On a mesh** (``ctx``, a ``ShardCtx`` of ``distributed/sharding.py``) the
step computes what the reference's ``make_train_step(cfg, ShardCtx(mesh,
default_rules(False, cfg)), optc)`` computes, with the placement of its
dry run (``repro/launch/dryrun.py::build_train``): params at
``tree_param_specs`` (:func:`train_specs`), the f32 ``master``, ``m`` and
``v`` at ``zero1_specs``.  Each rank runs its data shard's rows through
the tensor-parallel forward; the loss is the global batch's mean (the
token count summed over the data axes); a leaf's gradient is summed over
the data axes that do not shard it and cut to its ZeRO-1 block in the
same all-reduce (``_to_zero1``); AdamW updates the block and gathers the
new params over the data axes (``optim/adamw.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.distributed.sharding import (ShardCtx, all_reduce,
                                              default_rules, mesh_axis_size,
                                              reduce_from, slice_of,
                                              spec_axes, tree_param_specs,
                                              zero1_dim, zero1_specs)
from repro_torch.models import lm
from repro_torch.models.layers import tp_axes, vocab_shard
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim import OptConfig, adamw_step, compress_and_reduce


def train_specs(cfg, ctx) -> Tuple[Any, Any]:
    """``(param specs, ZeRO-1 specs)`` of ``cfg``'s params on ``ctx``'s
    mesh: ``tree_param_specs`` of the model's specs and ``zero1_specs`` of
    those, as the reference's dry run places its train step."""
    abstract = lm.abstract_params(cfg)
    pspecs = tree_param_specs(ctx, lm.model_specs(cfg), abstract)
    return pspecs, zero1_specs(pspecs, abstract, cfg, ctx)


def _mesh_ctx(ctx):
    return None if ctx is None or ctx.mesh is None else ctx


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor, cfg, ctx):
    """``(lse, gold)`` of f32 ``logits [B, c, V or V / n]``.  Where the
    model axis cut the vocabulary: the log-sum-exp from a max over the
    model axis (no gradient) and the sum of the exponentials over it (with
    one), and the gold logit from the rank that holds it."""
    shard = vocab_shard(ctx, logits.shape[-1], cfg)
    if shard is None:
        return (torch.logsumexp(logits, dim=-1),
                logits.gather(-1, labels[..., None])[..., 0])
    v0, n = shard
    mesh, tp = ctx.mesh, tp_axes(ctx)
    mx = all_reduce(logits.detach().amax(-1), mesh, tp, "max")
    se = reduce_from(torch.exp(logits - mx[..., None]).sum(-1), mesh, tp)
    local = labels - v0
    mine = (local >= 0) & (local < n)
    gold = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    return mx + torch.log(se), reduce_from(gold * mine, mesh, tp)


def chunked_ce_loss(params, hidden: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor, cfg, ctx=None, chunk: int = 1024
                    ) -> torch.Tensor:
    """``hidden [B, S, d]`` -> the mean cross entropy over the positions
    ``mask`` keeps, in f32, ``chunk`` positions at a time (the whole ``S``
    where ``S`` is not a multiple of ``chunk``).  On a mesh ``ctx`` the
    head is vocab-parallel and the count is summed over ``ctx``'s data
    axes, so each data rank returns its share of the global mean."""
    s = hidden.shape[1]
    if s % chunk != 0:
        chunk = s
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, s, chunk):
        logits = lm.logits_fn(params, hidden[:, c:c + chunk], cfg, ctx)
        lse, gold = _ce_terms(logits, labels[:, c:c + chunk].long(), cfg,
                              ctx)
        m = mask[:, c:c + chunk].to(torch.float32)
        tot = tot + torch.sum((lse - gold) * m)
        cnt = cnt + torch.sum(m)
    if ctx is not None and ctx.mesh_axes("batch"):
        cnt = all_reduce(cnt, ctx.mesh, ctx.mesh_axes("batch"))
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg,
            attn_impl: Optional[str] = None, ctx=None) -> torch.Tensor:
    """The train loss of ``batch`` (``tokens``, ``labels``, ``mask`` [B, S];
    ``frontend_embeds`` or ``src_embeds`` where the config takes them): a
    frontend's positions are input only."""
    ctx = _mesh_ctx(ctx)
    attn_impl = attn_impl or getattr(cfg, "attn_impl", "masked")
    hidden = lm.forward_train(params, batch, cfg, attn_impl=attn_impl,
                              ctx=ctx)
    if cfg.frontend and "frontend_embeds" in batch:
        hidden = hidden[:, batch["frontend_embeds"].shape[1]:]
    return chunked_ce_loss(params, hidden, batch["labels"], batch["mask"],
                           cfg, ctx)


def value_and_grad(params, batch: Dict[str, torch.Tensor], cfg,
                   attn_impl: Optional[str] = None, ctx=None
                   ) -> Tuple[torch.Tensor, Any]:
    """``(loss, grads)``: the loss and its gradient in every leaf of
    ``params`` (each in its leaf's dtype; zeros for a leaf the loss does
    not reach), as ``jax.value_and_grad`` gives them.  ``params`` are
    read, never written.  On a mesh ``ctx`` the loss is the global
    batch's (summed over the data axes, the same on every rank) and the
    gradients are this rank's share, not yet summed over them."""
    ctx = _mesh_ctx(ctx)
    with torch.enable_grad():
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = loss_fn(p, batch, cfg, attn_impl, ctx)
        leaves = tree_leaves(p)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else g
              for t, g in zip(leaves, grads))
    loss = loss.detach()
    if ctx is not None and ctx.mesh_axes("batch"):
        loss = all_reduce(loss, ctx.mesh, ctx.mesh_axes("batch"))
    return loss, tree_map(lambda _: next(it), p)


def _to_zero1(g: torch.Tensor, pspec, zspec, dp, mesh) -> torch.Tensor:
    """A leaf's gradient share -> its ZeRO-1 block of the whole gradient,
    in f32: summed over the data axes that do not shard the leaf (an
    expert-parallel expert is already whole), then sliced where ZeRO-1 cut
    it further."""
    g = g.to(torch.float32)
    free = tuple(a for a in dp if a not in spec_axes(pspec))
    if free:
        g = all_reduce(g, mesh, free)
    dim, axes = zero1_dim(pspec, zspec)
    return g if dim is None else slice_of(g, mesh, axes, dim).contiguous()


def make_train_step(cfg, optc: OptConfig, microbatch: Optional[int] = None,
                    attn_impl: Optional[str] = None, ctx=None) -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``: the
    gradients of the whole batch, or the mean of ``B // microbatch``
    microbatches' (accumulated in f32, each divided by their count), then
    :func:`repro_torch.optim.adamw_step`.  ``metrics`` holds ``loss``,
    ``lr`` and ``grad_norm`` as device scalars.

    On a mesh ``ctx`` the params are this rank's placement, ``opt_state``
    its ZeRO-1 blocks (``init_opt_state(params, placement=...)``) and
    ``batch`` its data shard (``data.sharded_batch``); ``microbatch``
    counts rows of the global batch, each data rank taking its share."""
    ctx = _mesh_ctx(ctx)
    placement = None
    dp = ()
    if ctx is not None:
        lm.check_train_mesh(cfg)
        pspecs, zspecs = train_specs(cfg, ctx)
        placement = (pspecs, zspecs, ctx.mesh)
        dp = ctx.mesh_axes("batch")
    shards = mesh_axis_size(ctx.mesh, dp) if dp else 1

    def step(params, opt_state, batch):
        if microbatch is None:
            loss, grads = value_and_grad(params, batch, cfg, attn_impl, ctx)
        else:
            rows = microbatch // shards
            n = batch["tokens"].shape[0] // rows
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = tree_map(lambda t: torch.zeros(
                t.shape, dtype=torch.float32, device=t.device), params)
            for i in range(n):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                l_i, g_i = value_and_grad(params, mb, cfg, attn_impl, ctx)
                grads = tree_map(lambda a, b: a + b.to(torch.float32) / n,
                                 grads, g_i)
                loss = loss + l_i / n
        if placement is not None:
            grads = tree_map(lambda g, ps, zs: _to_zero1(g, ps, zs, dp,
                                                         ctx.mesh),
                             grads, pspecs, zspecs)
        params, opt_state, mets = adamw_step(grads, opt_state, optc,
                                             params_like=params,
                                             placement=placement)
        return params, opt_state, {"loss": loss, **mets}

    return step


def _strip_data(ctx) -> ShardCtx:
    """``ctx`` with the data axes taken out of every rule: the reference's
    rules inside its ``shard_map`` that is manual over them."""
    dp = set(ctx.mesh_axes("batch")) | {"data", "pod"}

    def strip(v):
        axes = tuple(a for a in (v if isinstance(v, (tuple, list)) else (v,))
                     if a is not None and a not in dp)
        return axes if len(axes) > 1 else (axes[0] if axes else None)
    return ShardCtx(ctx.mesh, {k: strip(v) for k, v in ctx.rules.items()})


def make_compressed_grads(cfg, scheme: str = "bf16",
                          attn_impl: str = "masked",
                          mesh=None) -> Callable:
    """``(params, err_state, batch) -> (loss, grads, new_err)``: the loss
    and backward of this rank's data shard (its own mean, as the
    reference's ``shard_map`` body computes it), then
    :func:`repro_torch.optim.compress_and_reduce` over the data axes;
    ``loss`` is averaged over them.  Without ``mesh`` the group has one
    member.  ``err_state`` carries the reference's leading data-parallel
    axis: on a mesh, this rank's row (``init_dp_error_state(params)`` of
    its params).  ``params`` are this rank's placement
    (``tree_param_specs``): over a model axis above 1 the loss runs
    tensor-parallel inside, as the reference leaves the model axis to
    XLA.  ``cfg.fsdp`` raises, as in the reference: the scheme needs the
    params replicated over the group."""
    if cfg.fsdp:
        raise ValueError("compressed-DP requires DP-replicated params")
    inner, dp = None, ()
    if mesh is not None:
        lm.check_train_mesh(cfg)
        ctx = ShardCtx(mesh, default_rules("pod" in mesh.shape, cfg))
        dp = ctx.mesh_axes("batch")
        inner = _strip_data(ctx)
    n = mesh_axis_size(mesh, dp) if dp else 1

    def fn(params, err_state, batch):
        err = tree_map(lambda e: e[0], err_state)
        loss, grads = value_and_grad(params, batch, cfg, attn_impl, inner)
        g_hat, new_err = compress_and_reduce(grads, err, dp, scheme, mesh)
        if dp:
            loss = all_reduce(loss, mesh, dp) / n
        return loss, g_hat, tree_map(lambda e: e[None], new_err)

    return fn


def init_dp_error_state(params, dp_size: int = 1):
    """Per-member error-feedback buffers, a leading axis of ``dp_size``
    (a rank of a mesh holds its own row: ``dp_size=1`` of its params)."""
    return tree_map(lambda p: torch.zeros((dp_size,) + tuple(p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)
