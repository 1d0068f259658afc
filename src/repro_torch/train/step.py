"""The train step (twin of ``repro.train.step``): the chunked loss, the
gradients, microbatch accumulation and AdamW, and the compressed-gradient
step in its single-process form.

The loss computes the logits a chunk of positions at a time, so the
``[B, S, V]`` tensor never exists.  Gradients come from ``torch.autograd``
through :func:`repro_torch.models.lm.forward_train`: on the card every
dense linear and the tied head run the hand-written dense kernel in the
forward and in the remat replay (``kernels/dense_matmul.py::
DenseMatmulGrad``), and ``torch.matmul`` in the backward, as XLA
transposes the reference's ``jnp.dot``.  The data-parallel and sharded
forms wait for ROADMAP Queue 1 item 3 (the mesh).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import lm
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim import OptConfig, adamw_step, compress_and_reduce
from repro_torch.optim.grad_compress import MESH_ITEM


def chunked_ce_loss(params, hidden: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor, cfg, chunk: int = 1024
                    ) -> torch.Tensor:
    """``hidden [B, S, d]`` -> the mean cross entropy over the positions
    ``mask`` keeps, in f32, ``chunk`` positions at a time (the whole ``S``
    where ``S`` is not a multiple of ``chunk``)."""
    s = hidden.shape[1]
    if s % chunk != 0:
        chunk = s
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, s, chunk):
        logits = lm.logits_fn(params, hidden[:, c:c + chunk], cfg)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[:, c:c + chunk, None].long())[..., 0]
        m = mask[:, c:c + chunk].to(torch.float32)
        tot = tot + torch.sum((lse - gold) * m)
        cnt = cnt + torch.sum(m)
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg,
            attn_impl: Optional[str] = None) -> torch.Tensor:
    """The train loss of ``batch`` (``tokens``, ``labels``, ``mask`` [B, S];
    ``frontend_embeds`` or ``src_embeds`` where the config takes them): a
    frontend's positions are input only."""
    attn_impl = attn_impl or getattr(cfg, "attn_impl", "masked")
    hidden = lm.forward_train(params, batch, cfg, attn_impl=attn_impl)
    if cfg.frontend and "frontend_embeds" in batch:
        hidden = hidden[:, batch["frontend_embeds"].shape[1]:]
    return chunked_ce_loss(params, hidden, batch["labels"], batch["mask"],
                           cfg)


def value_and_grad(params, batch: Dict[str, torch.Tensor], cfg,
                   attn_impl: Optional[str] = None) -> Tuple[torch.Tensor,
                                                             Any]:
    """``(loss, grads)``: the loss and its gradient in every leaf of
    ``params`` (each in its leaf's dtype; zeros for a leaf the loss does
    not reach), as ``jax.value_and_grad`` gives them.  ``params`` are
    read, never written."""
    with torch.enable_grad():
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = loss_fn(p, batch, cfg, attn_impl)
        leaves = tree_leaves(p)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else g
              for t, g in zip(leaves, grads))
    return loss.detach(), tree_map(lambda _: next(it), p)


def make_train_step(cfg, optc: OptConfig, microbatch: Optional[int] = None,
                    attn_impl: Optional[str] = None) -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``: the
    gradients of the whole batch, or the mean of ``B // microbatch``
    microbatches' (accumulated in f32, each divided by their count), then
    :func:`repro_torch.optim.adamw_step`.  ``metrics`` holds ``loss``,
    ``lr`` and ``grad_norm`` as device scalars."""

    def step(params, opt_state, batch):
        if microbatch is None:
            loss, grads = value_and_grad(params, batch, cfg, attn_impl)
        else:
            n = batch["tokens"].shape[0] // microbatch
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = tree_map(lambda t: torch.zeros(
                t.shape, dtype=torch.float32, device=t.device), params)
            for i in range(n):
                mb = {k: v[i * microbatch:(i + 1) * microbatch]
                      for k, v in batch.items()}
                l_i, g_i = value_and_grad(params, mb, cfg, attn_impl)
                grads = tree_map(lambda a, b: a + b.to(torch.float32) / n,
                                 grads, g_i)
                loss = loss + l_i / n
        params, opt_state, mets = adamw_step(grads, opt_state, optc,
                                             params_like=params)
        return params, opt_state, {"loss": loss, **mets}

    return step


def make_compressed_grads(cfg, scheme: str = "bf16",
                          attn_impl: str = "masked",
                          mesh=None) -> Callable:
    """``(params, err_state, batch) -> (loss, grads, new_err)`` over one
    process: the loss and backward, then
    :func:`repro_torch.optim.compress_and_reduce` over the one-member
    group.  ``err_state`` carries the reference's leading data-parallel
    axis of size 1 (:func:`init_dp_error_state`).  A mesh raises (ROADMAP
    Queue 1 item 3), and so does ``cfg.fsdp``, as in the reference: the
    scheme needs params replicated over the group."""
    if cfg.fsdp:
        raise ValueError("compressed-DP requires DP-replicated params")
    if mesh is not None:
        raise NotImplementedError(MESH_ITEM)

    def fn(params, err_state, batch):
        err = tree_map(lambda e: e[0], err_state)
        loss, grads = value_and_grad(params, batch, cfg, attn_impl)
        g_hat, new_err = compress_and_reduce(grads, err, (), scheme)
        return loss, g_hat, tree_map(lambda e: e[None], new_err)

    return fn


def init_dp_error_state(params, dp_size: int = 1):
    """Per-member error-feedback buffers, a leading axis of ``dp_size``."""
    return tree_map(lambda p: torch.zeros((dp_size,) + tuple(p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)
