"""Pooled sparse-KV primitives (twin of the pooled half of
``repro.core.sparse_kv``): compress block-aligned K/V chunks at a static
per-block capacity, write them (and any other rows) under a device mask,
append fresh tokens into the dense tail ring, and view pooled block
storage as a :class:`BlockSparseWeight`.
"""
from __future__ import annotations

import numpy as np
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


def device_ids(x, shape, dev: torch.device) -> torch.Tensor:
    """A device tensor, or host values zero-padded to ``shape``, as int64
    ``shape`` on ``dev``: the pool transitions take their slots, counts and
    page ids as device operands.  Host values (direct callers) take a copy
    that waits for the device."""
    if torch.is_tensor(x) and x.device.type == dev.type:
        return x.to(dev).long().reshape(shape)
    a = np.zeros(shape, np.int64)
    v = np.asarray(x.cpu() if torch.is_tensor(x) else x, np.int64)
    a.reshape(-1)[:v.size] = v.reshape(-1)
    return torch.from_numpy(a).to(dev)


def put_rows_(dst: torch.Tensor, index: tuple, rows: torch.Tensor,
              live: torch.Tensor) -> None:
    """Masked row write, **in place**: ``dst[index] = where(live, rows,
    dst[index])``, at static shapes and without a host read.

    ``index`` is leading ``slice(None)``s followed by adjacent int64 index
    tensors ``[N]`` that select ``N`` rows (pass a transposed view of
    ``dst`` to bring the row axes together); ``rows`` is shaped like
    ``dst[index]`` and ``live [N]`` masks them: a masked row is written back
    with its own current contents, so only the live rows change.  This is
    the port's stand-in for the reference's ``mode="drop"`` scatters, which
    torch lacks.  The ``N`` destinations must be pairwise distinct, masked
    ones included: CUDA's ``index_put_`` with a repeated destination is
    nondeterministic even where both writes carry the same bytes
    (:func:`distinct_ids` makes a masked id list so)."""
    cur = dst[index]
    shape = [1] * cur.dim()
    shape[sum(isinstance(i, slice) for i in index)] = -1
    dst[index] = torch.where(live.reshape(shape), rows.to(dst.dtype), cur)


def distinct_ids(ids: torch.Tensor, live: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """Destinations for :func:`put_rows_` on an id axis of ``n`` rows: the
    live entries of ``ids [N]`` (pairwise distinct by the caller's
    contract, e.g. fresh pages) stay; each masked entry takes, in order,
    the lowest id in ``[0, n)`` that no live entry holds.  Computed on the
    device at static shapes (an integer count, a cumsum and a search)."""
    if ids.numel() > n:
        raise ValueError(f"{ids.numel()} masked row destinations need at "
                         f"least as many rows, got {n}")
    ids = ids.long().clamp(0, n - 1)
    used = torch.zeros(n, dtype=torch.int32, device=ids.device)
    used.index_add_(0, ids, live.to(torch.int32))
    free_upto = (used == 0).long().cumsum(0)          # free ids in [0, i]
    rank = (~live).long().cumsum(0)                   # 1-based among masked
    return torch.where(live, ids, torch.searchsorted(free_upto, rank))


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
