"""AdamW, the learning-rate schedule and global-norm clipping (twin of
``repro.optim.adamw``).

Mixed precision as in the reference: the model's params keep their dtypes
(bf16 matmul weights, f32 norm scales); the optimizer state holds an f32
master copy and f32 moments.  :func:`adamw_step` is functional (it returns
new tensors and writes into none it was given), and each new param is
built with ``torch.empty_like`` of its old self, so it keeps that leaf's
dtype **and layout**: a dense linear that ``serving/engine.py::params_to``
stored column-major for the dense kernel stays column-major after every
step (a plain ``master.to(dtype)`` would hand back a row-major tensor,
which the kernel refuses).

**ZeRO-1** (``placement=(param specs, zero1 specs, mesh)``): a rank holds
the ``zero1_specs`` block of each ``master`` / ``m`` / ``v`` leaf (its
param block cut once more over the data axes, on the first free dim that
divides), updates that block from the same block of the summed gradient,
and gathers the new params over the data axes.  The clipping norm is the
whole gradient's: each leaf's squares summed over exactly the mesh axes
that shard its block, so a replicated block counts once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed.sharding import (all_gather, all_reduce,
                                              spec_axes, zero1_dim,
                                              zero1_shard)
from repro_torch.models.module import tree_leaves, tree_map, tree_part


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    end_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_schedule(optc: OptConfig, step) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine down to ``end_lr_frac``
    of it at ``decay_steps``; f32, on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = optc.peak_lr * step / max(optc.warmup_steps, 1)
    prog = ((step - optc.warmup_steps)
            / max(optc.decay_steps - optc.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = optc.peak_lr * (optc.end_lr_frac + (1 - optc.end_lr_frac)
                          * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < optc.warmup_steps, warm, cos)


def init_opt_state(params: Any, placement=None) -> Dict[str, Any]:
    """``step`` (an int32 scalar), the f32 ``master`` copy and the zero
    moments ``m`` and ``v``, each leaf on its param's device and in its
    layout; with ``placement`` (ZeRO-1, ``params`` this rank's blocks)
    each rank's ``zero1_specs`` block, row-major."""
    leaf = tree_leaves(params)[0]
    if placement is not None:
        pspecs, zspecs, mesh = placement
        master = tree_map(lambda p, ps, zs: zero1_shard(
            p.detach(), ps, zs, mesh).to(torch.float32).contiguous()
            .clone(), params, pspecs, zspecs)
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=leaf.device),
                "master": master,
                "m": tree_map(torch.zeros_like, master),
                "v": tree_map(torch.zeros_like, master)}
    return {
        "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
        "master": tree_map(lambda p: p.detach().to(torch.float32,
                                                   copy=True), params),
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params),
    }


def abstract_opt_state(params: Any) -> Dict[str, Any]:
    """:func:`init_opt_state`'s shapes and dtypes as meta tensors."""
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    return {"step": torch.empty((), dtype=torch.int32, device="meta"),
            "master": tree_map(f32, params), "m": tree_map(f32, params),
            "v": tree_map(f32, params)}


def global_norm(tree: Any, specs: Any = None, mesh=None) -> torch.Tensor:
    """The f32 L2 norm over every leaf; with ``specs`` (a spec tree of the
    blocks ``tree`` holds on ``mesh``) the whole tree's: each leaf's
    squares summed over the axes that shard it, one all-reduce per set of
    axes."""
    if specs is None:
        return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                              for leaf in tree_leaves(tree)))
    sums: Dict[Tuple[str, ...], torch.Tensor] = {}
    for leaf, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        axes = tuple(a for a in spec_axes(spec) if mesh.shape[a] > 1)
        sq = torch.sum(torch.square(leaf.float()))
        sums[axes] = sums[axes] + sq if axes in sums else sq
    return torch.sqrt(sum(all_reduce(v, mesh, axes)
                          for axes, v in sums.items()))


def _gathered(master: torch.Tensor, like: torch.Tensor, pspec, zspec,
              mesh) -> torch.Tensor:
    """The new param block of a ZeRO-1 ``master`` block: cast to the
    param's dtype, gathered over the data axes ZeRO-1 cut, and copied
    into the old block's layout."""
    dim, axes = zero1_dim(pspec, zspec)
    t = master.to(like.dtype)
    if dim is not None:
        t = all_gather(t, mesh, axes, dim)
    return torch.empty_like(like, requires_grad=False).copy_(t)


def adamw_step(grads: Any, opt_state: Dict[str, Any], optc: OptConfig,
               params_like: Any = None, placement=None
               ) -> Tuple[Any, Dict[str, Any], Dict]:
    """One AdamW update with global-norm clipping and decoupled weight
    decay.  Returns ``(new params, new opt state, {"lr", "grad_norm"})``:
    each new param in the dtype and layout of its ``params_like`` leaf
    (bf16, row-major, without ``params_like``).  With ``placement``
    (ZeRO-1: ``(param specs, zero1 specs, mesh)``) ``grads`` and the
    state are this rank's ZeRO-1 blocks and ``params_like`` its param
    blocks."""
    step = opt_state["step"] + 1
    lr = lr_schedule(optc, step)
    gnorm = (global_norm(grads) if placement is None else
             global_norm(grads, placement[1], placement[2]))
    scale = (torch.clamp(optc.clip_norm / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if optc.clip_norm else 1.0)
    b1, b2 = optc.b1, optc.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        update = (m / bc1) / (torch.sqrt(v / bc2) + optc.eps)
        return m, v, p - lr * (update + optc.weight_decay * p)

    out = tree_map(upd, grads, opt_state["m"], opt_state["v"],
                   opt_state["master"])
    new_state = {"step": step, "m": tree_part(out, 0),
                 "v": tree_part(out, 1), "master": tree_part(out, 2)}
    if placement is not None:
        pspecs, zspecs, mesh = placement
        params = tree_map(lambda m, p, ps, zs: _gathered(m, p, ps, zs, mesh),
                          new_state["master"], params_like, pspecs, zspecs)
    elif params_like is None:
        params = tree_map(lambda m: m.to(torch.bfloat16),
                          new_state["master"])
    else:
        params = tree_map(lambda m, p: torch.empty_like(
            p, requires_grad=False).copy_(m), new_state["master"],
            params_like)
    return params, new_state, {"lr": lr, "grad_norm": gnorm}
