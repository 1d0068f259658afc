"""Pruning masks (twin of ``repro.core.pruning``): global and
block-balanced magnitude, and Wanda.

Tie order matters for parity: the reference ranks with ``lax.top_k``,
which keeps the lower index first among equal magnitudes, so the ranking
here is a *stable* descending sort.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .sparse_format import DEFAULT_BLOCK, _from_blocks, _to_blocks, \
    _topk_stable


def _kth_index(sparsity: float, size: int) -> int:
    """``clip(round(sparsity * size), 0, size - 1)`` as the reference
    computes it (round-half-even on a float32 product)."""
    k = int(np.round(np.float32(sparsity * size)))
    return min(max(k, 0), size - 1)


def prune_global(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Keep the largest-|w| ``(1-sparsity)`` fraction globally."""
    return prune_kv(w, sparsity)


def prune_balanced(w: torch.Tensor, sparsity: float,
                   block: Tuple[int, int] = DEFAULT_BLOCK) -> torch.Tensor:
    """Per-block top-k magnitude mask: exactly-balanced block occupancy."""
    if sparsity <= 0.0:
        return torch.ones_like(w, dtype=torch.bool)
    bk, bn = block
    keep = max(int(round((1.0 - sparsity) * bk * bn)), 1)
    wb = _to_blocks(w.abs(), block)                    # [Kb, Nb, L]
    idx = _topk_stable(wb, keep)
    mb = torch.zeros(wb.shape, dtype=torch.int32, device=w.device)
    mb.scatter_(-1, idx, 1)
    return _from_blocks(mb, block, tuple(w.shape)) > 0


def prune_wanda(w: torch.Tensor, act_norm: torch.Tensor, sparsity: float,
                per_output: bool = True) -> torch.Tensor:
    """Wanda (Sun et al., 2024): score ``|w| * ||x_k||``, pruned per output
    channel (column), or over the whole tensor with ``per_output=False``.
    The thresholds are read off a sort, as in the reference, so every entry
    tied with a threshold is kept exactly where the reference keeps it."""
    score = w.abs() * act_norm[:, None]
    if not per_output:
        k = int(round(sparsity * score.numel()))
        thr = torch.sort(score.reshape(-1)).values[max(k - 1, 0)]
        return score >= thr
    keep = max(int(round((1.0 - sparsity) * w.shape[0])), 1)
    thr = torch.sort(score, dim=0).values[-keep, :]
    return score >= thr[None, :]


def prune_kv(kv: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Magnitude mask over the whole tensor: drop the lowest-|.| values."""
    if sparsity <= 0.0:
        return torch.ones_like(kv, dtype=torch.bool)
    return prune_kv_rows(kv.reshape(1, -1), sparsity).reshape(kv.shape)


def prune_kv_rows(rows: torch.Tensor, sparsity: float) -> torch.Tensor:
    """:func:`prune_kv` applied independently to every row of ``[R, X]``
    (the per-(slot, block) thresholds of the pooled KV freeze)."""
    if sparsity <= 0.0:
        return torch.ones_like(rows, dtype=torch.bool)
    a = rows.abs()
    k = _kth_index(sparsity, a.shape[-1])
    thr = torch.sort(a, dim=-1).values[:, k:k + 1]
    return a >= thr


def make_mask(w: torch.Tensor, sparsity: float, policy: str = "balanced",
              block: Tuple[int, int] = DEFAULT_BLOCK,
              act_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    if policy == "global":
        return prune_global(w, sparsity)
    if policy == "balanced":
        return prune_balanced(w, sparsity, block)
    if policy == "wanda":
        if act_norm is None:
            raise ValueError("wanda needs per-input-channel act norms")
        return prune_wanda(w, act_norm, sparsity)
    raise ValueError(f"unknown pruning policy {policy!r}")
