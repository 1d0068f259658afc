"""Mesh-aware sparse-conversion planning (twin of
``repro.distributed.convert_plan``).

Weights are packed for a fixed mesh: each eligible 2D weight gets a block
shape and a block-count padding, so that its packed block axes shard
exactly like the dense axes they replace:

* if the sharded dense axis has at least as many blocks as its mesh axis
  has ranks, the block count is padded up to a multiple of that size;
* otherwise the tensor replicates on that axis (small tensors).

3D expert-stacked weights stay dense under tensor parallelism, as in the
reference.  :func:`convert_concrete` with ``NULL_CTX`` is the single-rank
conversion (``repro_torch.core.convert.convert_concrete``).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.convert import MODES, _pack_leaf, _to_int4, \
    default_predicate
from repro_torch.core.pruning import make_mask
from repro_torch.core.quant import quantize_weight_int4
from repro_torch.core.sparse_format import (DEFAULT_BLOCK, BlockSparseWeight,
                                            _ceil_to, balanced_capacity, pack)
from repro_torch.models import module as mod
from .sharding import ShardCtx, mesh_axis_size


def _fit_block(dim: int, pref: int) -> int:
    """Shrink the preferred block edge for small tensors; keep multiples of
    8 so bitmaps stay word-aligned."""
    if dim >= pref:
        return pref
    return max(-(-dim // 8) * 8, 8)


def _plan_leaf(spec: mod.ParamSpec, ctx: ShardCtx, block=DEFAULT_BLOCK
               ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """-> (block, pad_to_blocks) for one (possibly layer-stacked) 2D
    weight."""
    k, n = spec.shape[-2:]
    block = (_fit_block(k, block[0]), _fit_block(n, block[1]))
    bk, bn = block
    axes = (spec.axes or (None,) * len(spec.shape))[-2:]
    kb = -(-k // bk)
    nb = -(-n // bn)
    pk = mesh_axis_size(ctx.mesh, ctx.rules.get(axes[0]))
    pn = mesh_axis_size(ctx.mesh, ctx.rules.get(axes[1]))
    pad_k = pk if (pk > 1 and kb >= pk) else 1
    pad_n = pn if (pn > 1 and nb >= pn) else 1
    return block, (pad_k, pad_n)


def _is_sparsifiable(path: str, spec) -> bool:
    """2D weights, or layer-stacked 2D weights (leading 'layers' axis).
    Expert-stacked (axis 'experts') weights stay dense under TP."""
    if not mod.is_spec(spec) or not default_predicate(path, spec):
        return False
    if len(spec.shape) == 2:
        return True
    axes = spec.axes or ()
    return len(spec.shape) == 3 and len(axes) == 3 and axes[0] == "layers"


def _abstract_packed(spec: mod.ParamSpec, density: float, blk, pad,
                     mode: str) -> BlockSparseWeight:
    """Meta-tensor ``BlockSparseWeight`` of a packed leaf (the reference's
    ``packed_spec``): ``[*lead, Kb, Nb, bk*bn // 32]`` bitmap words,
    ``[*lead, Kb, Nb, C]`` values (int4: ``C // 2`` bytes), an f32
    ``[*lead, Nb*bn]`` scale for the int modes."""
    k, n = spec.shape[-2:]
    bk, bn = blk
    kb = _ceil_to(-(-k // bk), pad[0])
    nb = _ceil_to(-(-n // bn), pad[1])
    cap = balanced_capacity(density, blk)
    lead = tuple(spec.shape[:-2])
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    int_mode = mode in ("int8", "int4")
    if mode == "int4":
        values = meta(lead + (kb, nb, cap // 2), torch.uint8)
    else:
        values = meta(lead + (kb, nb, cap),
                      torch.int8 if int_mode else torch.bfloat16)
    return BlockSparseWeight(
        bitmap=meta(lead + (kb, nb, bk * bn // 32), torch.int32),
        values=values,
        scale=meta(lead + (nb * bn,), torch.float32) if int_mode else None,
        shape=(int(k), int(n)), block=tuple(blk), packed4=mode == "int4")


def convert_abstract(params_abs: Any, spec_tree: Any, cfg, ctx: ShardCtx,
                     mode: str = "bf16", block=DEFAULT_BLOCK) -> Any:
    """Meta-tensor params -> a tree with meta ``BlockSparseWeight`` leaves
    of the planned shapes (nothing allocated)."""
    density = 1.0 - cfg.sparsity

    def one(path: str, pair):
        spec, leaf = pair
        if not _is_sparsifiable(path, spec):
            return leaf
        blk, pad = _plan_leaf(spec, ctx, block)
        return _abstract_packed(spec, density, blk, pad, mode)
    return mod.map_with_path(one, _zip(spec_tree, params_abs),
                             is_leaf=lambda x: isinstance(x, tuple))


def _pack_one(w2: torch.Tensor, cfg, blk, pad, cap, mode: str
              ) -> BlockSparseWeight:
    if mode != "int4":
        # packed bf16 values whatever the model dtype (as the reference)
        return _pack_leaf(w2, cfg.sparsity, cfg.sparse_policy, blk, mode,
                          pad, cap)
    mask = make_mask(w2, cfg.sparsity, cfg.sparse_policy, blk)
    q, scale = quantize_weight_int4(torch.where(mask, w2, 0))
    return _to_int4(pack(q, mask, blk, capacity=cap, pad_to_blocks=pad,
                         scale=scale))


def convert_concrete(params: Any, spec_tree: Any, cfg, ctx: ShardCtx,
                     mode: str = "bf16", block=DEFAULT_BLOCK,
                     device: Optional[torch.device] = None) -> Any:
    """Prune + pack (and for ``mode="int8"|"int4"`` quantise) every linear
    weight of ``params`` under the mesh-aware plan, on ``device`` (the
    CUDA device unless the caller asks for the CPU)."""
    if mode not in MODES:
        raise ValueError(f"unknown conversion mode {mode!r}")
    dev = resolve_device(device)
    density = 1.0 - cfg.sparsity

    def one(path: str, pair):
        spec, leaf = pair
        leaf = leaf.to(dev)
        if not _is_sparsifiable(path, spec):
            return leaf
        blk, pad = _plan_leaf(spec, ctx, block)
        cap = balanced_capacity(density, blk)
        if leaf.ndim == 3:                  # layer-stacked: pack per layer
            packed = [_pack_one(leaf[i], cfg, blk, pad, cap, mode)
                      for i in range(leaf.shape[0])]
            return BlockSparseWeight(
                bitmap=torch.stack([p.bitmap for p in packed]),
                values=torch.stack([p.values for p in packed]),
                scale=(None if packed[0].scale is None
                       else torch.stack([p.scale for p in packed])),
                shape=packed[0].shape, block=blk,
                packed4=packed[0].packed4)
        return _pack_one(leaf, cfg, blk, pad, cap, mode)

    return mod.map_with_path(one, _zip(spec_tree, params),
                             is_leaf=lambda x: isinstance(x, tuple))


def _zip(spec_tree, params):
    if isinstance(spec_tree, dict):
        return {k: _zip(v, params[k]) for k, v in spec_tree.items()}
    return (spec_tree, params)
