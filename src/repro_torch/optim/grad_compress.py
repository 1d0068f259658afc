"""Gradient compression with error feedback (twin of
``repro.optim.grad_compress``).

Each gradient is compressed with the error it left last time added in,
and the new error is what the compression lost:

    q_t = compress(g_t + e_t);  e_t+1 = (g_t + e_t) - q_t;  g_hat = reduce(q_t)

Schemes: ``bf16`` (a cast) and ``int8`` (per-tensor symmetric, the scale
from the group's largest magnitude).  Over a data-parallel group of ranks
(``axis_names`` on ``mesh``), as the reference's ``psum`` / ``pmax`` inside
``shard_map``:

* ``bf16``: the bf16 ``q`` are all-gathered over the group (bf16 on the
  wire, as the reference's ``psum`` operand) and summed in f32 in the
  group's rank order, then rounded to bf16 once and divided by the
  group's size in f32: every member gets the same bits,
  ``bf16(q_0 + q_1 + ...) / n``.  An all-reduce would sum in gloo's own
  order, and under cancellation an f32 sum's rounding moves the bf16
  result by several ulps (ROADMAP Queue 3).
* ``int8``: the group scale is the largest magnitude over every rank (a
  max all-reduce of the local largest, over the model axis too where it
  cuts the leaf: the reference takes it over the whole leaf), and the
  ``q`` are summed in int32, which is exact.

Over one process the group has one member: the sum is the identity,
``n = 1`` and the group's largest magnitude is the local one.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import (all_gather, all_reduce,
                                              mesh_axis_size)
from repro_torch.models.module import tree_map, tree_part


def init_error_state(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _ordered_sum(q: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The f32 sum of every member's bf16 ``q`` over ``axes``, in rank
    order (``q`` itself without axes)."""
    if not axes:
        return q.to(torch.float32)
    parts = all_gather(q[None], mesh, axes, 0)
    total = parts[0].to(torch.float32)
    for part in parts[1:]:
        total = total + part.to(torch.float32)
    return total


def _one(g: torch.Tensor, e: torch.Tensor, scheme: str, axes, mesh):
    acc = g.to(torch.float32) + e
    n = mesh_axis_size(mesh, axes) if axes else 1
    if scheme == "bf16":
        q = acc.to(torch.bfloat16)
        return (_ordered_sum(q, axes, mesh).to(torch.bfloat16)
                .to(torch.float32) / n, acc - q.to(torch.float32))
    total = (lambda t: all_reduce(t, mesh, axes)) if axes else (lambda t: t)
    if scheme == "int8":
        amax = acc.abs().max()
        if mesh is not None:
            amax = all_reduce(amax, mesh, tuple(mesh.shape), "max")
        scale = torch.clamp(amax, min=1e-12) / 127.0
        q = torch.clamp(torch.round(acc / scale), -127, 127).to(torch.int8)
        return (total(q.to(torch.int32)).to(torch.float32) * scale / n,
                acc - q.to(torch.float32) * scale)
    raise ValueError(scheme)


def compress_and_reduce(grads: Any, err_state: Any,
                        axis_names: Sequence[str] = (),
                        scheme: str = "bf16", mesh=None) -> Tuple[Any, Any]:
    """``(g_hat, new error state)``, both f32: ``g_hat`` the group's mean
    of the decompressed ``q`` over ``axis_names`` of ``mesh`` (the
    reference's data-parallel axes; none: a one-member group)."""
    axes = tuple(axis_names)
    if axes and mesh is None:
        raise ValueError(f"a reduction over {axes} needs the mesh")
    out = tree_map(lambda g, e: _one(g, e, scheme, axes, mesh), grads,
                   err_state)
    return tree_part(out, 0), tree_part(out, 1)
