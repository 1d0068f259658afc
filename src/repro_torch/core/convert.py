"""Dense -> sparse parameter conversion.

Twin of two reference pieces: ``repro.core.convert`` (which leaves are
linear weights: ``default_predicate`` / ``EXCLUDE_KEYS``;
``convert_to_sparse``, which prunes and packs every selected leaf of any
params tree, and ``sparsity_report``) and the single-device path of
``repro.distributed.convert_plan.convert_concrete`` (per-leaf block fitted
by ``_fit_block`` / ``_plan_leaf``, capacity from ``balanced_capacity``,
layer-stacked leaves packed per layer) in its three modes: ``"bf16"``
values, ``"int8"`` values with a per-channel f32 scale, and ``"int4"``
(the int8 path quantised to ``[-7, 7]`` and nibble-packed).  There is no
mesh, so ``convert_concrete`` pads no block counts (``convert_to_sparse``
takes the reference's ``pad_to_blocks``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import module as mod
from .pruning import make_mask
from .quant import quantize_weight_int4, quantize_weight_int8
from .sparse_format import (DEFAULT_BLOCK, BlockSparseWeight,
                            balanced_capacity, pack, pack_nibbles)

MODES = ("bf16", "int8", "int4")

# Param-name suffixes that are linear-layer weights (matmul RHS, [K, N]).
LINEAR_KEYS = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down", "w_in",
               "w_out", "w_r", "w_k", "w_v", "w_g", "w_o", "w_ck", "w_cv",
               "w_cr", "w_proj", "w1", "w2", "w3", "lm_head")
EXCLUDE_KEYS = ("embed", "norm", "scale", "bias", "router", "pos",
                "a_log", "dt", "mu_", "decay", "bonus")


def default_predicate(path: str, leaf: Any) -> bool:
    """Is the leaf (a tensor or a ``ParamSpec``) at ``path`` a linear
    weight?"""
    if len(leaf.shape) < 2:
        return False
    if any(k in path for k in EXCLUDE_KEYS):
        return False
    name = path.rsplit("/", 1)[-1]
    return any(name == k or name.endswith("/" + k) for k in LINEAR_KEYS)


def _fit_block(dim: int, pref: int) -> int:
    """Shrink the preferred block edge for small tensors; keep multiples of
    8 so bitmaps stay word-aligned."""
    if dim >= pref:
        return pref
    return max(-(-dim // 8) * 8, 8)


def _plan_leaf(spec: mod.ParamSpec, block=DEFAULT_BLOCK) -> Tuple[int, int]:
    k, n = spec.shape[-2:]
    return (_fit_block(k, block[0]), _fit_block(n, block[1]))


def _is_sparsifiable(path: str, spec) -> bool:
    """2D weights, or layer-stacked 2D weights (leading 'layers' axis)."""
    if not mod.is_spec(spec) or not default_predicate(path, spec):
        return False
    if len(spec.shape) == 2:
        return True
    axes = spec.axes or ()
    return len(spec.shape) == 3 and len(axes) == 3 and axes[0] == "layers"


def _to_int4(sw: BlockSparseWeight) -> BlockSparseWeight:
    """int8-valued packed weight -> nibble-packed int4 (the capacity is a
    multiple of 128, hence even)."""
    return BlockSparseWeight(sw.bitmap, pack_nibbles(sw.values), sw.scale,
                             sw.shape, sw.block, packed4=True)


def _pack_one(w2: torch.Tensor, cfg, blk, cap, mode: str
              ) -> BlockSparseWeight:
    if mode != "int4":
        # packed bf16 values whatever the model dtype (as the reference)
        return _pack_leaf(w2, cfg.sparsity, cfg.sparse_policy, blk, mode,
                          (1, 1), cap)
    mask = make_mask(w2, cfg.sparsity, cfg.sparse_policy, blk)
    q, scale = quantize_weight_int4(torch.where(mask, w2, 0))
    return _to_int4(pack(q, mask, blk, capacity=cap, scale=scale))


def convert_concrete(params: Any, spec_tree: Any, cfg, mode: str = "bf16",
                     block=DEFAULT_BLOCK,
                     device: Optional[torch.device] = None) -> Any:
    """Prune + pack (and for ``mode="int8"|"int4"`` quantise) every linear
    weight of ``params`` on ``device`` (the CUDA device unless the caller
    asks for the CPU)."""
    if mode not in MODES:
        raise ValueError(f"unknown conversion mode {mode!r}")
    dev = resolve_device(device)
    density = 1.0 - cfg.sparsity

    def one(path: str, pair):
        spec, leaf = pair
        leaf = leaf.to(dev)
        if not _is_sparsifiable(path, spec):
            return leaf
        blk = _plan_leaf(spec, block)
        cap = balanced_capacity(density, blk)
        if leaf.ndim == 3:                  # layer-stacked: pack per layer
            packed = [_pack_one(leaf[i], cfg, blk, cap, mode)
                      for i in range(leaf.shape[0])]
            return BlockSparseWeight(
                bitmap=torch.stack([p.bitmap for p in packed]),
                values=torch.stack([p.values for p in packed]),
                scale=(None if packed[0].scale is None
                       else torch.stack([p.scale for p in packed])),
                shape=packed[0].shape, block=blk,
                packed4=packed[0].packed4)
        return _pack_one(leaf, cfg, blk, cap, mode)

    return mod.map_with_path(one, _zip(spec_tree, params),
                             is_leaf=lambda x: isinstance(x, tuple))


def _zip(spec_tree, params):
    if isinstance(spec_tree, dict):
        return {k: _zip(v, params[k]) for k, v in spec_tree.items()}
    return (spec_tree, params)


def _pack_leaf(w: torch.Tensor, sparsity: float, policy: str,
               block: Tuple[int, int], mode: str,
               pad_to_blocks: Tuple[int, int],
               capacity: Optional[int]) -> BlockSparseWeight:
    if w.dim() == 3:
        # stacked experts [E, K, N]: fold E into K; blocks never straddle
        # experts as long as K % bk == 0
        e, k, n = w.shape
        if k % block[0] != 0:
            raise ValueError(
                f"expert in-dim {k} must be a multiple of bk={block[0]}")
        w = w.reshape(e * k, n)
    mask = make_mask(w, sparsity, policy, block)
    if mode == "int8":
        q, scale = quantize_weight_int8(torch.where(mask, w, 0))
        return pack(q, mask, block, capacity=capacity,
                    pad_to_blocks=pad_to_blocks, scale=scale)
    return pack(w.to(torch.bfloat16) if mode == "bf16" else w, mask, block,
                capacity=capacity, pad_to_blocks=pad_to_blocks)


def convert_to_sparse(params: Any,
                      sparsity: float = 0.5,
                      policy: str = "balanced",
                      block: Tuple[int, int] = DEFAULT_BLOCK,
                      mode: str = "bf16",
                      pad_to_blocks: Tuple[int, int] = (1, 1),
                      capacity: Optional[int] = None,
                      predicate: Callable[[str, Any], bool] = default_predicate
                      ) -> Any:
    """Replace every dense tensor of ``params`` that ``predicate(path,
    leaf)`` selects with a :class:`BlockSparseWeight`, on the tensor's own
    device.  ``mode``: ``"bf16"`` (values cast to bf16), ``"keep"`` (the
    leaf's dtype) or ``"int8"`` (per-channel scales).  A 3-D leaf is a
    stack of experts ``[E, K, N]``, packed as one ``[E*K, N]`` weight."""
    return mod.map_with_path(
        lambda p, leaf: (_pack_leaf(leaf, sparsity, policy, block, mode,
                                    pad_to_blocks, capacity)
                         if predicate(p, leaf) else leaf),
        params, is_leaf=torch.is_tensor)


def sparsity_report(params: Any) -> Dict[str, Dict[str, float]]:
    """Per-leaf compression statistics for converted trees."""
    out = {}

    def one(path, leaf):
        out[path] = {"dense_bytes": leaf.nbytes_dense(),
                     "compressed_bytes": leaf.nbytes_compressed(),
                     "ratio": leaf.compression_ratio(),
                     "capacity": leaf.capacity}
        return leaf
    mod.map_with_path(one, params,
                      is_leaf=lambda x: isinstance(x, BlockSparseWeight))
    return out
