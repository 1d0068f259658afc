"""Dense -> sparse parameter conversion.

Twin of two reference pieces: ``repro.core.convert`` (which leaves are
linear weights: ``default_predicate`` / ``EXCLUDE_KEYS``;
``convert_to_sparse``, which prunes and packs every selected leaf of any
params tree, and ``sparsity_report``) and the single-rank path of
``repro.distributed.convert_plan.convert_concrete`` (the mesh-aware plan
lives in ``repro_torch/distributed/convert_plan.py``; its ``NULL_CTX``
case pads no block counts) in its three modes: ``"bf16"`` values,
``"int8"`` values with a per-channel f32 scale, and ``"int4"`` (the int8
path quantised to ``[-7, 7]`` and nibble-packed).  ``convert_to_sparse``
takes the reference's ``pad_to_blocks``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import module as mod
from .pruning import make_mask
from .quant import quantize_weight_int8
from .sparse_format import DEFAULT_BLOCK, BlockSparseWeight, pack, \
    pack_nibbles

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


def _to_int4(sw: BlockSparseWeight) -> BlockSparseWeight:
    """int8-valued packed weight -> nibble-packed int4 (the capacity is a
    multiple of 128, hence even)."""
    return BlockSparseWeight(sw.bitmap, pack_nibbles(sw.values), sw.scale,
                             sw.shape, sw.block, packed4=True)


def convert_concrete(params: Any, spec_tree: Any, cfg, mode: str = "bf16",
                     block=DEFAULT_BLOCK,
                     device: Optional[torch.device] = None) -> Any:
    """Prune + pack (and for ``mode="int8"|"int4"`` quantise) every linear
    weight of ``params`` on ``device`` (the CUDA device unless the caller
    asks for the CPU): the single-rank case (``NULL_CTX``) of
    :func:`repro_torch.distributed.convert_plan.convert_concrete`."""
    from repro_torch.distributed import NULL_CTX, convert_plan
    return convert_plan.convert_concrete(params, spec_tree, cfg, NULL_CTX,
                                         mode, block, device)


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
