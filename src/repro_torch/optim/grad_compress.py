"""Gradient compression with error feedback (twin of
``repro.optim.grad_compress``), in its single-process form.

Each gradient is compressed with the error it left last time added in,
and the new error is what the compression lost:

    q_t = compress(g_t + e_t);  e_t+1 = (g_t + e_t) - q_t;  g_hat = reduce(q_t)

Schemes: ``bf16`` (a cast) and ``int8`` (per-tensor symmetric, the scale
from the group's largest magnitude).  Over one process the data-parallel
group has one member: the reduction's sum is the identity, ``n = 1`` and
the group's largest magnitude is the local one, so ``g_hat`` is the
decompressed ``q_t``, exactly as the reference computes it on a size-1
axis.  The collective over a data-parallel group (the reference's ``psum``
and ``pmax`` inside ``shard_map``) waits for ROADMAP Queue 1 item 3, the
mesh.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch

from repro_torch.models.module import tree_map, tree_part

MESH_ITEM = ("the compressed reduction over a data-parallel group waits for "
             "ROADMAP Queue 1 item 3 (the mesh)")


def init_error_state(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _one(g: torch.Tensor, e: torch.Tensor, scheme: str):
    acc = g.to(torch.float32) + e
    if scheme == "bf16":
        q = acc.to(torch.bfloat16)
        return q.to(torch.float32), acc - q.to(torch.float32)
    if scheme == "int8":
        scale = torch.clamp(acc.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(acc / scale), -127, 127).to(torch.int8)
        return (q.to(torch.int32).to(torch.float32) * scale,
                acc - q.to(torch.float32) * scale)
    raise ValueError(scheme)


def compress_and_reduce(grads: Any, err_state: Any,
                        axis_names: Sequence[str] = (),
                        scheme: str = "bf16") -> Tuple[Any, Any]:
    """``(g_hat, new error state)``, both f32, over the one-process group.
    ``axis_names`` names the reduction's data-parallel axes in the
    reference; any axis here raises (the mesh item)."""
    if tuple(axis_names):
        raise NotImplementedError(MESH_ITEM)
    out = tree_map(lambda g, e: _one(g, e, scheme), grads, err_state)
    return tree_part(out, 0), tree_part(out, 1)
