"""Sparse KV cache: compressed frozen prefix + dense tail (twin of
``repro.core.sparse_kv``, paper §6.2).

Two cache families:

* :class:`SparseKVCache`, the legacy one-shot layout of the static-batch
  :class:`~repro_torch.serving.engine.Engine`: the prefill cache pruned and
  packed at a capacity the data sets, fresh tokens appended to a dense tail
  ring, and a refreeze that folds a full tail back into a longer prefix
  (new shapes, so the one-shot engine runs eagerly);
* the **pooled** primitives of the serving ``CachePool``: compress
  block-aligned K/V chunks at a static per-block capacity, write them (and
  any other rows) under a device mask, append fresh tokens into the tail
  ring, and view pooled block storage as a :class:`BlockSparseWeight`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .pruning import prune_kv, prune_kv_rows
from .sparse_format import (BlockSparseWeight, balanced_capacity, pack,
                            pack_blocks, unpack)

KV_BLOCK_TOKENS = 128


# ---------------------------------------------------------------------------
# the legacy one-shot cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SparseKVCache:
    """Per-layer compressed KV state (optionally stacked over periods: every
    tensor then has a leading period axis, sliced by :meth:`layer`).

    ``k_sp``/``v_sp``: packed from the ``[B*Hkv*S, D]`` cache view in
    ``(bs, D)`` blocks, structured as ``[B, Hkv, Sb, 1, X]``;
    ``k_tail``/``v_tail``: dense ``[B, Hkv, T, D]`` rings for fresh tokens;
    ``tail_len``: int32 scalar, the valid tail entries (on the device)."""
    k_sp: BlockSparseWeight
    v_sp: BlockSparseWeight
    k_tail: torch.Tensor
    v_tail: torch.Tensor
    tail_len: torch.Tensor

    @property
    def prefix_len(self) -> int:
        b, hkv, _, _ = self.k_tail.shape[-4:]
        if self.k_sp.bitmap.dim() >= 5:                 # structured
            return self.k_sp.shape[0]
        return self.k_sp.shape[0] // (b * hkv)

    def layer(self, i: int) -> "SparseKVCache":
        """Period ``i`` of a stacked cache (views, no copy)."""
        return SparseKVCache(self.k_sp.layer(i), self.v_sp.layer(i),
                             self.k_tail[i], self.v_tail[i],
                             self.tail_len[i])

    @staticmethod
    def stack(caches: List["SparseKVCache"]) -> "SparseKVCache":
        """Stack per-period caches of one capacity along a new axis 0."""
        st = lambda get: torch.stack([get(c) for c in caches])

        def sw(get):
            w = [get(c) for c in caches]
            return BlockSparseWeight(
                torch.stack([x.bitmap for x in w]),
                torch.stack([x.values for x in w]), None, w[0].shape,
                w[0].block, w[0].packed4)
        return SparseKVCache(sw(lambda c: c.k_sp), sw(lambda c: c.v_sp),
                             st(lambda c: c.k_tail), st(lambda c: c.v_tail),
                             st(lambda c: c.tail_len))


def freeze_prefix(k: torch.Tensor, v: torch.Tensor,
                  k_sparsity: float = 0.3, v_sparsity: float = 0.5,
                  tail_size: int = 128, bs: int = KV_BLOCK_TOKENS,
                  capacity_k: Optional[int] = None,
                  capacity_v: Optional[int] = None,
                  structured: bool = True) -> SparseKVCache:
    """Prune and pack a dense prefill cache ``k/v [B, Hkv, S, D]``: a
    magnitude threshold over the whole layer (paper §6.1), ``(bs, D)``
    blocks, capacity from the data unless given.  ``structured=True`` (the
    layout the decode attention reads) stores the block arrays as ``[B,
    Hkv, Sb, 1, X]``; ``False`` keeps the flat ``[(B*Hkv*Sb), 1, X]``."""
    b, hkv, s, d = k.shape
    if s % bs != 0:
        raise ValueError(f"prefix length {s} must be a multiple of {bs}")
    kf = k.reshape(b * hkv * s, d)
    vf = v.reshape(b * hkv * s, d)
    k_sp = pack(kf, prune_kv(kf, k_sparsity), block=(bs, d),
                capacity=capacity_k)
    v_sp = pack(vf, prune_kv(vf, v_sparsity), block=(bs, d),
                capacity=capacity_v)
    if structured:
        k_sp = structure_kv(k_sp, b, hkv)
        v_sp = structure_kv(v_sp, b, hkv)
    zeros = lambda: torch.zeros((b, hkv, tail_size, d), dtype=k.dtype,
                                device=k.device)
    return SparseKVCache(k_sp, v_sp, zeros(), zeros(),
                         torch.zeros((), dtype=torch.int32, device=k.device))


def structure_kv(sw: BlockSparseWeight, b: int, hkv: int
                 ) -> BlockSparseWeight:
    """Flat ``[(B*Hkv*Sb), 1, X]`` block arrays -> ``[B, Hkv, Sb, 1, X]``;
    the logical shape becomes the per-(b, h) ``(S, D)``, so :func:`unpack`
    yields ``[B, Hkv, S, D]``."""
    rows_total, nb, _ = sw.bitmap.shape
    sb = rows_total // (b * hkv)
    bs, d = sw.block
    re = lambda a: a.reshape(b, hkv, sb, nb, a.shape[-1])
    return BlockSparseWeight(bitmap=re(sw.bitmap), values=re(sw.values),
                             scale=sw.scale, shape=(sb * bs, d),
                             block=sw.block, packed4=sw.packed4)


def append_token(cache: SparseKVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> SparseKVCache:
    """O(1) append of one token ``k/v_new [B, Hkv, D]`` at ``tail_len``,
    **in place** (the tail and ``tail_len`` are the cache's own storage;
    the index stays on the device), returning ``cache``."""
    idx = cache.tail_len.long().reshape(1)
    cache.k_tail.index_copy_(2, idx, k_new[:, :, None].to(cache.k_tail.dtype))
    cache.v_tail.index_copy_(2, idx, v_new[:, :, None].to(cache.v_tail.dtype))
    cache.tail_len += 1
    return cache


def refreeze(cache: SparseKVCache, k_sparsity: float = 0.3,
             v_sparsity: float = 0.5) -> SparseKVCache:
    """Fold a full tail back into the compressed prefix (paper §6.2's
    amortised step).  The tail must be a whole number of blocks and full;
    the result has a longer prefix, an empty tail and possibly a larger
    capacity (a new cache: the shapes change)."""
    b, hkv, t, d = cache.k_tail.shape
    bs = cache.k_sp.block[0]
    if t % bs != 0:
        raise ValueError(f"tail {t} not a multiple of block {bs}")
    structured = cache.k_sp.bitmap.dim() == 5
    k_pref = unpack(cache.k_sp)
    v_pref = unpack(cache.v_sp)
    if not structured:
        s = cache.k_sp.shape[0] // (b * hkv)
        k_pref = k_pref.reshape(b, hkv, s, d)
        v_pref = v_pref.reshape(b, hkv, s, d)
    k = torch.cat([k_pref, cache.k_tail.to(k_pref.dtype)], dim=2)
    v = torch.cat([v_pref, cache.v_tail.to(v_pref.dtype)], dim=2)
    # the old prefix is pruned already: re-pruning it is a no-op beyond
    # threshold drift, the paper's layer-wide magnitude rule
    return freeze_prefix(k, v, k_sparsity, v_sparsity, tail_size=t, bs=bs,
                         structured=structured)


def maybe_refreeze(cache: SparseKVCache, k_sparsity: float,
                   v_sparsity: float) -> SparseKVCache:
    """Refreeze when the tail is full; reads ``tail_len`` (a host sync,
    this helper's purpose)."""
    if int(cache.tail_len) >= cache.k_tail.shape[2]:
        return refreeze(cache, k_sparsity, v_sparsity)
    return cache


def abstract_cache(batch: int, hkv: int, prefix: int, d: int,
                   k_density: float = 0.7, v_density: float = 0.5,
                   tail_size: int = 128, bs: int = KV_BLOCK_TOKENS,
                   dtype=torch.bfloat16, structured: bool = True
                   ) -> SparseKVCache:
    """A cache of meta tensors (shapes and dtypes, nothing allocated) at
    the balanced capacity the densities imply."""
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    sb = -(-prefix // bs)
    words = bs * d // 32

    def sw(density):
        cap = balanced_capacity(density, (bs, d))
        lead = (batch, hkv, sb) if structured else (batch * hkv * sb,)
        return BlockSparseWeight(
            bitmap=meta(lead + (1, words), torch.int32),
            values=meta(lead + (1, cap), dtype), scale=None,
            shape=(sb * bs, d) if structured else (batch * hkv * prefix, d),
            block=(bs, d))
    tail = lambda: meta((batch, hkv, tail_size, d), dtype)
    return SparseKVCache(sw(k_density), sw(v_density), tail(), tail(),
                         meta((), torch.int32))


# ---------------------------------------------------------------------------
# pooled-cache primitives
# ---------------------------------------------------------------------------


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


# the sanitized pool's error word (``serving/cache_pool.py``): bit ``i`` set
# means check ``CHECKS[i]`` failed.  The first six are the reference's
# ``checkify.check`` messages; the last stands in for its NaN screen.
CHECKS = ("refreeze: fresh id out of arena range",
          "refreeze: fresh id already referenced (copy-on-write violation)",
          "refreeze: full slot would overflow max_blocks",
          "assign_blocks: n out of range",
          "assign_blocks: block id out of arena range",
          "release: refcount underflow (device double free)",
          "nan: a NaN was written into the pool")
NAN_CHECK = CHECKS.index("nan: a NaN was written into the pool")


def flag_(err: torch.Tensor, bad: torch.Tensor, check: int) -> None:
    """OR bit ``check`` into the error word ``err`` (int32 ``[1]``) where
    any entry of ``bad`` is true, in place and without a host read."""
    err.bitwise_or_(bad.any().reshape(1).to(torch.int32) << check)


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
