"""Slot-pooled sparse-KV cache for continuous batching (twin of
``repro.serving.cache_pool``: ``CachePool`` flat and paged, and the host
``BlockAllocator``).

Storage is sized once, data moves within it: per layer every slot owns a
fixed grid of ``max_blocks`` compressed sequence blocks (bitmap words +
packed values at a static per-block capacity) and a dense ``tail`` ring.
Occupancy lives in three int32 ``[slots]`` vectors (``pos``,
``prefix_blocks``, ``tail_len``); validity is masked, never re-shaped.

**Paged mode** (``paged=True``): compressed blocks live once in a
pool-global arena ``[P, n_phys, Hkv, X]``; each slot's prefix is a row of
the int32 ``table [slots, max_blocks]`` and ``refcount [n_phys]`` counts
the rows that point at each block.  Requests whose prompts share a
block-aligned prefix point at the same physical blocks.  Frozen blocks are
immutable: refreeze and prefill write only fresh ids handed out by the
host :class:`BlockAllocator` (copy-on-write at the divergence block by
construction).

The transitions update the state dict's tensors **in place** (the pool is
the largest state on the card; the reference's functional copies would
double its traffic) and return the same dict.

**Sanitized mode** (``checkify=True``, or ``REPRO_CHECKIFY=1`` in the
environment; the reference's ``jax.experimental.checkify`` mode).  The
state then carries an int32 **error word** ``err [1]`` on the device, and
every check of the reference ORs its own bit into it (:data:`CHECKS`) with
tensor operations alone: no host read, so a checked transition is captured
into a CUDA graph like any other.  One more bit flags a NaN in the values
a transition or a forward writes into the pool, in place of the
reference's ``nan_checks``; its ``div_checks`` have nothing to screen in
the port's integer transitions.  :func:`checkified` reads the word after
an eager call and raises naming every set bit; the engine reads it in the
same device-to-host copy as a tick's tokens.  Without the flag no
transition holds a single extra operation.

**Snapshots.**  :meth:`CachePool.geometry`, :meth:`CachePool.arena_leaves`
and :meth:`CachePool.load_arena` (which writes into the live arena tensors,
so every captured entry that reads them stays valid) with the allocator's
:meth:`BlockAllocator.export_registered` / :meth:`BlockAllocator.restore_registered`
carry the paged arena and its prefix index across a restart.
"""
from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bridge import tensor_from_numpy
from repro_torch.core.sparse_format import LANE, _ceil_to
from repro_torch.core.sparse_kv import (CHECKS, NAN_CHECK, append_tail_panel,
                                         device_ids, distinct_ids, flag_,
                                         freeze_chunk_blocks, put_rows_)
from repro_torch.models import lm
from repro_torch.models.lm import ARENA_KEYS

@dataclasses.dataclass(frozen=True)
class CachePool:
    """Geometry + state transitions of the pooled serving cache."""
    cfg: Any
    slots: int
    max_blocks: int          # compressed-prefix capacity, in (bs,)-blocks
    bs: int                  # tokens per compressed block
    tail: int                # dense-tail ring size (tokens)
    cap_k: int               # packed K values per block (static)
    cap_v: int
    device: torch.device = torch.device("cpu")
    paged: bool = False      # pool-global arena + per-slot block table
    n_phys: int = 0          # physical blocks in the paged arena
    checkify: bool = False   # sanitized mode: the device error word

    @classmethod
    def build(cls, cfg, slots: int, max_tokens: int, bs: int = 0,
              capacity_slack: float = 1.25,
              device: Optional[torch.device] = None, paged: bool = False,
              n_phys: int = 0, checkify: Optional[bool] = None
              ) -> "CachePool":
        """Size a pool for ``slots`` requests of up to ``max_tokens`` context
        each; per-block capacity is the nominal density times the block
        size, times ``capacity_slack``, rounded to the lane size.

        ``paged=True`` stores compressed blocks in a shared arena of
        ``n_phys`` blocks (default ``slots * max_blocks``, the flat pool's
        prefix bytes) behind per-slot block tables.  ``checkify`` (default:
        ``REPRO_CHECKIFY`` set to anything but ``0``) builds the sanitized
        mode."""
        lm._attn_kinds(cfg)
        bs = bs or min(128, cfg.kv_tail)
        if cfg.kv_tail % bs != 0:
            raise ValueError(
                f"kv_tail={cfg.kv_tail} is not a multiple of the block "
                f"size bs={bs}: refreeze folds the dense tail into whole "
                f"(bs,)-token compressed blocks")
        l = bs * cfg.hd

        def cap(sparsity: float) -> int:
            density = 1.0 - sparsity
            if density >= 1.0:
                return l
            return min(_ceil_to(int(round(density * l * capacity_slack)),
                                LANE), l)
        max_blocks = max(-(-int(max_tokens) // bs), 1)
        if paged:
            n_phys = n_phys or slots * max_blocks
        if checkify is None:
            checkify = os.environ.get("REPRO_CHECKIFY", "0") not in ("", "0")
        return cls(cfg=cfg, slots=slots, max_blocks=max_blocks, bs=bs,
                   tail=cfg.kv_tail, cap_k=cap(cfg.kv_k_sparsity),
                   cap_v=cap(cfg.kv_v_sparsity),
                   device=resolve_device(device), paged=paged,
                   n_phys=n_phys if paged else 0, checkify=bool(checkify))

    @property
    def capacity_tokens(self) -> int:
        """Max context a slot may be admitted for (prefix storage alone)."""
        return self.max_blocks * self.bs

    def nbytes(self) -> int:
        """Total pooled storage, for capacity planning (nothing is
        allocated to count it)."""
        meta = dataclasses.replace(self, device=torch.device("meta"))
        return sum(t.numel() * t.element_size()
                   for t in tensors(meta.init_state()))

    def geometry(self) -> Dict[str, Any]:
        """Everything a snapshot of the paged arena depends on, under the
        reference's field names and values, so that either package's
        manifest checks against the other's pool.  ``slots`` is absent on
        purpose: the arena ``[P, n_phys, Hkv, X]`` does not depend on it, so
        a restarted server may change its slot count and still restore."""
        cfg = self.cfg
        return {
            "arch": cfg.name,
            "paged": self.paged,
            "bs": self.bs,
            "max_blocks": self.max_blocks,
            "n_phys": self.n_phys,
            "cap_k": self.cap_k,
            "cap_v": self.cap_v,
            "n_kv": cfg.n_kv,
            "hd": cfg.hd,
            "n_periods": cfg.n_layers // lm.period_len(cfg),
            "cdtype": str(cfg.cdtype).replace("torch.", ""),
            "kv_k_sparsity": cfg.kv_k_sparsity,
            "kv_v_sparsity": cfg.kv_v_sparsity,
        }

    def init_state(self) -> Dict[str, Any]:
        """Zeroed pool state.  Layer leaves carry a leading period axis:
        compressed ``[P, slots, Hkv, max_blocks, X]`` (paged: the arena
        ``[P, n_phys, Hkv, X]`` plus ``table [slots, max_blocks]`` and
        ``refcount [n_phys]`` int32), tails ``[P, slots, Hkv, tail, hd]``;
        bitmaps are int32 bit-views."""
        cfg = self.cfg
        n_periods = cfg.n_layers // lm.period_len(cfg)
        hkv, hd, dt = cfg.n_kv, cfg.hd, cfg.cdtype
        b, sb, w = self.slots, self.max_blocks, self.bs * hd // 32
        z = lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                             device=self.device)

        grid = ((n_periods, self.n_phys, hkv) if self.paged
                else (n_periods, b, hkv, sb))

        def kv_leaf():
            return {
                "k_bitmap": z(grid + (w,), torch.int32),
                "k_values": z(grid + (self.cap_k,), dt),
                "v_bitmap": z(grid + (w,), torch.int32),
                "v_values": z(grid + (self.cap_v,), dt),
                "k_tail": z((n_periods, b, hkv, self.tail, hd), dt),
                "v_tail": z((n_periods, b, hkv, self.tail, hd), dt),
            }
        state = {
            "pos": z((b,), torch.int32),
            "prefix_blocks": z((b,), torch.int32),
            "tail_len": z((b,), torch.int32),
            "layers": {f"l{j}": {"kv": kv_leaf()}
                       for j in range(lm.period_len(cfg))},
        }
        if self.paged:
            state["table"] = z((b, sb), torch.int32)
            state["refcount"] = z((self.n_phys,), torch.int32)
        if self.checkify:
            state["err"] = z((1,), torch.int32)
        return state

    def refreeze(self, state: Dict[str, Any], new_ids=None,
                 write=None) -> Dict[str, Any]:
        """Fold every full tail into its slot's next free prefix blocks.

        At static shapes, without a host read: ``full = tail_len >= tail``
        is computed on the device, every slot's tail is compressed, each
        slot's ``tail // bs`` blocks are written at its own
        ``prefix_blocks`` offset and only the full slots' are kept (the
        others are written back as they were, so those slots come back
        bit-identical).  ``write`` (bool ``[1]``, default true) false folds
        nothing.  The caller guarantees no full slot overflows
        ``max_blocks`` (scheduler admission); the sanitized mode checks it,
        and that each full slot's fresh ids lie in the arena (an id the
        reference would drop is clamped here, so both bounds are checked)
        and are unreferenced.

        Paged pool: ``new_ids`` ``[slots, tail // bs]`` (int64 on the
        device, or host values) carries a fresh physical id per (full
        slot, tail block) from the host allocator; rows of slots that are
        not full are ignored.  The blocks land at those ids in the arena and
        in each full slot's table row, and the ids' refcounts go to 1."""
        cfg, dev = self.cfg, self.device
        t, tb, b = self.tail, self.tail // self.bs, self.slots
        if self.paged and new_ids is None:
            raise ValueError("paged refreeze needs fresh ids")
        if tb > self.max_blocks:
            raise ValueError(f"a {t}-token tail folds into {tb} blocks; the "
                             f"slots hold {self.max_blocks}")
        full = state["tail_len"] >= t
        if write is not None:
            full = full & write.to(dev, torch.bool)
        live = full[:, None].expand(b, tb).reshape(-1)      # [B * tb]
        pb = state["prefix_blocks"].long()
        blk = ((pb[:, None] + torch.arange(tb, device=dev))
               % self.max_blocks).reshape(-1)               # distinct a slot
        slot_blk = torch.arange(b, device=dev)[:, None].expand(
            b, tb).reshape(-1)
        if self.paged:
            ids = device_ids(new_ids, (b, tb), dev).reshape(-1)
            dest = distinct_ids(ids, live, self.n_phys)
            if self.checkify:
                rc = state["refcount"][ids.clamp(0, self.n_phys - 1)]
                flag_(state["err"],
                      live & ((ids < 0) | (ids >= self.n_phys)), 0)
                flag_(state["err"], live & (rc != 0), 1)
        if self.checkify:
            flag_(state["err"], full & (pb + tb > self.max_blocks), 2)
        for leaf in state["layers"].values():
            kv = leaf["kv"]
            p_, _, hkv, _, hd = kv["k_tail"].shape
            flat = lambda a: a.reshape(p_ * b, hkv, t, hd)
            frozen = freeze_chunk_blocks(
                flat(kv["k_tail"]), flat(kv["v_tail"]),
                cfg.kv_k_sparsity, cfg.kv_v_sparsity, self.bs,
                self.cap_k, self.cap_v)
            for key, upd in zip(ARENA_KEYS, frozen):
                # [P*B, Hkv, tb, X] -> rows [P, B*tb, Hkv, X]
                rows = upd.reshape(p_, b, hkv, tb, -1).permute(
                    0, 1, 3, 2, 4).reshape(p_, b * tb, hkv, -1)
                if self.checkify and rows.is_floating_point():
                    nan = torch.isnan(rows).any(3).any(2).any(0)
                    flag_(state["err"], nan & live, NAN_CHECK)
                if self.paged:                      # [P, n_phys, Hkv, X]
                    put_rows_(kv[key], (slice(None), dest), rows, live)
                else:                               # [P, B, Sb, Hkv, X]
                    put_rows_(kv[key].transpose(2, 3),
                              (slice(None), slot_blk, blk), rows, live)
        if self.paged:
            ids = ids.clamp(0, self.n_phys - 1)
            put_rows_(state["table"], (slot_blk, blk), ids, live)
            state["refcount"].index_add_(0, ids, live.to(torch.int32))
        state["prefix_blocks"] += full.to(torch.int32) * tb
        state["tail_len"].masked_fill_(full, 0)
        return state

    def assign_blocks(self, state: Dict[str, Any], slot, ids, n,
                      write=None) -> Dict[str, Any]:
        """Point a freshly admitted slot's table row at ``n`` existing
        physical blocks (a prefix-cache hit): entries ``[0, n)`` become
        ``ids[:n]`` (the rest 0), the blocks' refcounts increment and the
        slot's lengths jump to the shared prefix (``n`` blocks, empty
        tail) — the prefill those blocks would have needed is skipped.
        ``slot`` and ``n`` (int64 ``[1]``) and ``ids`` (int64
        ``[max_blocks]``, entries past ``n`` ignored) may be device tensors
        or host values; ``write`` (bool ``[1]``, default true) false changes
        nothing.  The sanitized mode checks ``0 <= n <= max_blocks`` and the
        ids in ``[0, n)`` against the arena.  Paged pools only."""
        if not self.paged:
            raise ValueError("assign_blocks is a paged-pool transition")
        dev, sb = self.device, self.max_blocks
        slot = device_ids(slot, (1,), dev)
        n = device_ids(n, (1,), dev)
        wr = (torch.ones(1, dtype=torch.bool, device=dev) if write is None
              else write.to(dev, torch.bool).reshape(1))
        ids = device_ids(ids, (sb,), dev)
        live = (torch.arange(sb, device=dev) < n) & wr
        if self.checkify:
            flag_(state["err"], wr & ((n < 0) | (n > sb)), 3)
            flag_(state["err"],
                  live & ((ids < 0) | (ids >= self.n_phys)), 4)
        ids = ids.clamp(0, self.n_phys - 1)
        put_rows_(state["table"], (slot,),
                  torch.where(live, ids, 0)[None], wr)
        state["refcount"].index_add_(0, ids, live.to(torch.int32))
        put_rows_(state["pos"], (slot,), n * self.bs, wr)
        put_rows_(state["prefix_blocks"], (slot,), n, wr)
        put_rows_(state["tail_len"], (slot,), torch.zeros_like(n), wr)
        return state

    def append_many(self, state: Dict[str, Any], panels: Dict[str, Any],
                    n) -> Dict[str, Any]:
        """Append up to ``m`` fresh K/V tokens per slot into every layer's
        tail ring (``panels[layer]["k"|"v"]`` ``[P, B, Hkv, m, D]``; ``n``
        valid tokens per slot), advancing ``pos`` / ``tail_len``."""
        n = torch.broadcast_to(torch.as_tensor(n, dtype=torch.int32,
                                               device=self.device),
                               (self.slots,))
        tl = state["tail_len"].clone()
        for name, leaf in state["layers"].items():
            kv, src = leaf["kv"], panels[name]
            for i in range(kv["k_tail"].shape[0]):
                append_tail_panel(kv["k_tail"][i], src["k"][i], tl, n)
                append_tail_panel(kv["v_tail"][i], src["v"][i], tl, n)
        state["pos"] += n
        state["tail_len"] += n
        return state

    def rollback(self, state: Dict[str, Any], n) -> Dict[str, Any]:
        """Un-append the last ``n`` tokens per slot (clamped to the tail):
        a pure length decrement."""
        n = torch.broadcast_to(torch.as_tensor(n, dtype=torch.int32,
                                               device=self.device),
                               (self.slots,))
        n = torch.minimum(torch.clamp(n, min=0), state["tail_len"])
        state["pos"] -= n
        state["tail_len"] -= n
        return state

    def release(self, state: Dict[str, Any], slot) -> Dict[str, Any]:
        """Recycle one or many slots (``-1`` entries match nothing): zero
        their lengths; stale storage stays, fully masked.  Paged pool: each
        released slot's live table entries decrement their blocks'
        refcounts (shared blocks once per referencing slot) and its table
        row resets to 0; the host allocator decides what a refcount-0 block
        becomes.  Idempotent: a free slot has no live entries, so even the
        sanitized mode's underflow check (a live entry whose block has
        refcount 0) passes."""
        slot = torch.atleast_1d(torch.as_tensor(slot, dtype=torch.int32,
                                                device=self.device))
        rel = (slot[:, None] == torch.arange(
            self.slots, dtype=torch.int32, device=self.device)[None]).any(0)
        if self.paged:
            live = rel[:, None] & (
                torch.arange(self.max_blocks, device=self.device)[None]
                < state["prefix_blocks"][:, None])
            if self.checkify:
                rc = state["refcount"][state["table"].long().clamp(
                    0, self.n_phys - 1)]
                flag_(state["err"], live & (rc <= 0), 5)
            # every table entry adds -1 if live, else 0: no data-dependent
            # shape, so the release never waits for the device
            state["refcount"].index_add_(
                0, state["table"].long().reshape(-1),
                -live.reshape(-1).to(torch.int32))
            state["table"].masked_fill_(rel[:, None], 0)
        for key in ("pos", "prefix_blocks", "tail_len"):
            state[key].masked_fill_(rel, 0)
        return state

    # -- snapshot (the paged arena) -----------------------------------------
    def arena_leaves(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The shared-arena storage of a paged pool, ``{layer: {leaf:
        tensor}}``: exactly the leaves a warm-restart snapshot persists
        (tails, tables and lengths are in-flight request state; after a
        crash only the shareable frozen content survives).  The live
        tensors themselves, not copies:
        :meth:`~repro_torch.checkpoint.CheckpointManager.save` copies them
        to the host."""
        if not self.paged:
            raise ValueError("arena_leaves is a paged-pool helper")
        return {name: {k: leaf["kv"][k] for k in ARENA_KEYS}
                for name, leaf in state["layers"].items()}

    def load_arena(self, state: Dict[str, Any],
                   leaves: Dict[str, Any]) -> Dict[str, Any]:
        """Inverse of :meth:`arena_leaves`: copy ``leaves`` (tensors on any
        device, or the reference's numpy arrays) **into** the live arena
        tensors, which every captured entry reads by address, so nothing
        is captured again.  Every leaf's shape and dtype is checked, the
        failing one named, before any is copied: a restore never
        half-applies.  Returns ``state``."""
        if not self.paged:
            raise ValueError("load_arena is a paged-pool helper")
        pairs = []
        for name, leaf in state["layers"].items():
            for k in ARENA_KEYS:
                have = leaf["kv"][k]
                got = leaves[name][k]
                if not torch.is_tensor(got):
                    got = tensor_from_numpy(got, "cpu")
                if have.shape != got.shape or have.dtype != got.dtype:
                    raise ValueError(
                        f"arena leaf {name}/{k}: pool expects "
                        f"{tuple(have.shape)} {have.dtype}, snapshot carries "
                        f"{tuple(got.shape)} {got.dtype}")
                pairs.append((have, got))
        for have, got in pairs:
            have.copy_(got)
        return state


def tensors(tree: Any) -> List[torch.Tensor]:
    """The tensors of a state dict (nested dicts), in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    return [tree]


class PoolCheckError(RuntimeError):
    """A check of the sanitized pool failed (the port's counterpart of the
    reference's ``JaxRuntimeError`` from ``err.throw()``)."""


def check_errors(word: int) -> None:
    """Raise :class:`PoolCheckError` naming every check whose bit is set in
    the error word ``word`` (a host int); a zero word passes."""
    if word:
        failed = [msg for i, msg in enumerate(CHECKS) if word >> i & 1]
        raise PoolCheckError("sanitized pool: " + "; ".join(failed))


def checkified_raw(fn: Callable) -> Callable:
    """The capture-safe half of :func:`checkified`: ``fn'(state, ...)``
    runs the transition and returns ``(err, out)``, ``err`` being the
    state's device error word (int32 ``[1]``; zeros for an unchecked
    pool), not read.  The engine reads it at its own token read."""
    def run(state, *args, **kwargs):
        out = fn(state, *args, **kwargs)
        err = state.get("err")
        if err is None:
            err = torch.zeros(1, dtype=torch.int32,
                              device=state["pos"].device)
        return err, out
    return run


def checkified(fn: Callable) -> Callable:
    """Run a pool transition eagerly and then read the error word: raises
    :class:`PoolCheckError` naming every failed check (the twin of the
    reference's ``err.throw()``) and clears the word, so each failure is
    raised once.  The read waits for the device; captured entries use
    :func:`checkified_raw` instead."""
    def run(state, *args, **kwargs):
        out = fn(state, *args, **kwargs)
        err = state.get("err")
        word = 0 if err is None else int(err.item())
        if word:
            err.zero_()
            check_errors(word)
        return out
    return run


class BlockAllocator:
    """Host-side physical-block lifecycle of the paged pool (a copy of the
    reference's, numpy only).

    The device transitions are pure data motion; this object decides which
    ids they move.  Three populations partition ``[0, n_phys)``:

    * **free** — never used or fully reclaimed; a LIFO stack;
    * **live** — refcount > 0: referenced by at least one slot's table row;
    * **cached** — refcount 0 but still holding a registered
      (content-hashed) block, kept in an LRU so that a later prompt sharing
      the prefix can revive it.  ``alloc`` evicts from the LRU's cold end
      only when the free stack runs dry, invalidating the hash through
      ``on_evict`` (the engine points it at its prefix index).

    It mirrors the refcounts so admission can reason about availability
    without a device sync; the device ``refcount`` vector carries the same
    counts.
    """

    def __init__(self, n_phys: int,
                 on_evict: Optional[Callable[[int], None]] = None):
        self.n_phys = n_phys
        self.on_evict = on_evict
        self.evictions = 0               # lifetime LRU evictions
        self._free: List[int] = list(range(n_phys - 1, -1, -1))
        self._ref = np.zeros(n_phys, np.int64)
        self._cached: "OrderedDict[int, int]" = OrderedDict()  # id -> hash
        self._hash2id: Dict[int, int] = {}

    # -- queries ------------------------------------------------------------
    def free_blocks(self) -> int:
        """Blocks an ``alloc`` could hand out right now (free + evictable)."""
        return len(self._free) + len(self._cached)

    def refcount(self, bid: int) -> int:
        return int(self._ref[bid])

    def lookup(self, h: int) -> Optional[int]:
        """Physical id of the block registered under chained hash ``h``."""
        return self._hash2id.get(h)

    def hash_of(self, bid: int) -> Optional[int]:
        for h, i in self._hash2id.items():
            if i == bid:
                return h
        return None

    # -- lifecycle ----------------------------------------------------------
    def alloc(self, n: int) -> List[int]:
        """Hand out ``n`` fresh ids at refcount 1, evicting the LRU's cold
        end when the free stack runs dry.  Admission reservations guarantee
        this never runs out; failure is a bookkeeping bug."""
        ids = []
        for _ in range(n):
            if self._free:
                bid = self._free.pop()
            else:
                if not self._cached:
                    raise RuntimeError(
                        "BlockAllocator exhausted: admission reservations "
                        "must cover every alloc")
                bid, h = self._cached.popitem(last=False)      # LRU evict
                del self._hash2id[h]
                self.evictions += 1
                if self.on_evict is not None:
                    self.on_evict(h)
            self._ref[bid] = 1
            ids.append(bid)
        return ids

    def register(self, bid: int, h: int) -> bool:
        """Associate a live block with its chained content hash so later
        prompts can share it.  First writer wins; returns whether the hash
        was recorded."""
        if h in self._hash2id:
            return False
        self._hash2id[h] = bid
        return True

    def incref(self, ids: Sequence[int]) -> None:
        """Take shared references (a prefix-cache hit); revives cached
        refcount-0 blocks out of the eviction LRU."""
        for bid in ids:
            if self._ref[bid] == 0:
                self._cached.pop(bid, None)
            self._ref[bid] += 1

    # -- snapshot -------------------------------------------------------------
    def export_registered(self) -> List[tuple]:
        """``(hash, id)`` of every registered (content-hashed) block, coldest
        first: the cached refcount-0 blocks in eviction order, then the
        live ones.  Unregistered live blocks (private pages of in-flight
        requests) are left out: no prefix hit can revive them."""
        pairs = [(h, bid) for bid, h in self._cached.items()]
        pairs.extend((h, bid) for h, bid in self._hash2id.items()
                     if self._ref[bid] > 0)
        return pairs

    def validate_registered(self, pairs: Sequence[tuple]) -> None:
        """Raise ``ValueError`` on ids out of range or duplicated."""
        seen = set()
        for _, bid in pairs:
            if not 0 <= bid < self.n_phys:
                raise ValueError(f"snapshot block id {bid} outside arena "
                                 f"[0, {self.n_phys})")
            if bid in seen:
                raise ValueError(f"snapshot block id {bid} duplicated")
            seen.add(bid)

    def restore_registered(self, pairs: Sequence[tuple]) -> None:
        """Reset to a freshly restarted warm state: every ``(hash, id)``
        becomes a cached refcount-0 block (revivable by a prefix hit,
        evictable from the cold end in ``pairs`` order), every other id is
        free.  Validates first (:meth:`validate_registered`), so a corrupt
        snapshot changes nothing."""
        self.validate_registered(pairs)
        seen = {bid for _, bid in pairs}
        self._ref = np.zeros(self.n_phys, np.int64)
        self._free = [i for i in range(self.n_phys - 1, -1, -1)
                      if i not in seen]
        self._cached = OrderedDict((bid, h) for h, bid in pairs)
        self._hash2id = {h: bid for h, bid in pairs}

    def decref(self, ids: Sequence[int]) -> None:
        """Drop references (slot release).  A block reaching refcount 0
        parks in the LRU if its hash is registered (revivable), else
        returns to the free stack."""
        for bid in ids:
            if not self._ref[bid] > 0:
                raise RuntimeError(f"double free of block {bid}")
            self._ref[bid] -= 1
            if self._ref[bid] == 0:
                h = self.hash_of(bid)
                if h is None:
                    self._free.append(bid)
                else:
                    self._cached[bid] = h
                    self._cached.move_to_end(bid)
