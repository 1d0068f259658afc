"""Pooled sparse-KV primitives (twin of the pooled half of
``repro.core.sparse_kv``): compress block-aligned K/V chunks at a static
per-block capacity, append fresh tokens into the dense tail ring, and view
pooled block storage as a :class:`BlockSparseWeight`.
"""
from __future__ import annotations

import torch

from .pruning import prune_kv_rows
from .sparse_format import BlockSparseWeight, pack_blocks


def freeze_chunk_blocks(k: torch.Tensor, v: torch.Tensor,
                        k_sparsity: float, v_sparsity: float,
                        bs: int, cap_k: int, cap_v: int):
    """Compress a block-aligned chunk ``k/v [B, Hkv, C, D]`` (``C % bs ==
    0``) -> ``(k_bitmap [B, Hkv, Cb, bs*D//32], k_values [B, Hkv, Cb,
    cap_k], v_bitmap, v_values)``.

    The magnitude threshold is per (batch entry, token block) over
    ``(Hkv, bs, D)``, so a frozen block's bytes depend only on its own
    tokens; each ``(bs, D)`` block is then packed at the static capacity,
    overflow dropped from bitmap and values together."""
    b, hkv, c, d = k.shape
    if c % bs != 0:
        raise ValueError(f"context {c} not a multiple of block {bs}")
    nb = c // bs

    def block_mask(a, sparsity):
        rows = a.reshape(b, hkv, nb, bs * d).permute(0, 2, 1, 3) \
            .reshape(b * nb, hkv * bs * d)
        m = prune_kv_rows(rows, sparsity)
        return m.reshape(b, nb, hkv, bs * d).permute(0, 2, 1, 3)

    def blocks(a):
        return a.reshape(b, hkv, nb, bs * d)
    k_bm, k_vals = pack_blocks(blocks(k), block_mask(k, k_sparsity), cap_k)
    v_bm, v_vals = pack_blocks(blocks(v), block_mask(v, v_sparsity), cap_v)
    return k_bm, k_vals, v_bm, v_vals


def append_tail_panel(tail: torch.Tensor, new: torch.Tensor,
                      tail_len: torch.Tensor, n_valid: torch.Tensor) -> None:
    """Masked multi-token append into the dense tail ring, **in place**
    (the ring is the pool's storage; rewriting it whole per token would
    double its memory traffic).

    ``tail [B, Hkv, T, D]``; ``new [B, Hkv, m, D]``; slot ``b`` writes its
    first ``n_valid[b]`` panel tokens at ``tail_len[b] + j``.  Writes that
    would land past the ring end are dropped.  Panel tokens are written one
    at a time, so a dropped write (re-storing the ring's current value at a
    clamped row) never shadows a kept one."""
    b, _, t, _ = tail.shape
    m = new.shape[2]
    dev = tail.device
    rows = torch.arange(b, device=dev)
    tail_len = torch.broadcast_to(torch.as_tensor(tail_len, device=dev),
                                  (b,)).long()
    n_valid = torch.broadcast_to(torch.as_tensor(n_valid, device=dev),
                                 (b,)).long()
    for j in range(m):
        off = tail_len + j
        ok = (j < n_valid) & (off < t)
        idx = off.clamp(max=t - 1)
        cur = tail[rows, :, idx]                       # [B, Hkv, D]
        tail[rows, :, idx] = torch.where(ok[:, None, None],
                                         new[:, :, j].to(tail.dtype), cur)


def pooled_view(bitmap: torch.Tensor, values: torch.Tensor, bs: int, d: int
                ) -> BlockSparseWeight:
    """Pooled block arrays ``[B, Hkv, Sb, X]`` -> the structured view
    (``[B, Hkv, Sb, 1, X]``) the decode attention consumes (no copy)."""
    sb = bitmap.shape[2]
    return BlockSparseWeight(bitmap=bitmap[:, :, :, None],
                             values=values[:, :, :, None], scale=None,
                             shape=(sb * bs, d), block=(bs, d))
