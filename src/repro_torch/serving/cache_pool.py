"""Slot-pooled sparse-KV cache for continuous batching, flat mode (twin of
``repro.serving.cache_pool.CachePool`` without the paged arena).

Storage is sized once, data moves within it: per layer every slot owns a
fixed grid of ``max_blocks`` compressed sequence blocks (bitmap words +
packed values at a static per-block capacity) and a dense ``tail`` ring.
Occupancy lives in three int32 ``[slots]`` vectors (``pos``,
``prefix_blocks``, ``tail_len``); validity is masked, never re-shaped.

The transitions update the state dict's tensors **in place** (the pool is
the largest state on the card; the reference's functional copies would
double its traffic) and return the same dict.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.sparse_format import LANE, _ceil_to
from repro_torch.core.sparse_kv import append_tail_panel, freeze_chunk_blocks
from repro_torch.models import lm

# per-block packed capacity over the nominal density (the reference's
# ``capacity_slack`` default)
CAPACITY_SLACK = 1.25


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

    @classmethod
    def build(cls, cfg, slots: int, max_tokens: int, bs: int = 0,
              device: Optional[torch.device] = None) -> "CachePool":
        """Size a pool for ``slots`` requests of up to ``max_tokens`` context
        each; per-block capacity is the nominal density times the block
        size, times :data:`CAPACITY_SLACK`, rounded to the lane size."""
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
            return min(_ceil_to(int(round(density * l * CAPACITY_SLACK)),
                                LANE), l)
        max_blocks = max(-(-int(max_tokens) // bs), 1)
        return cls(cfg=cfg, slots=slots, max_blocks=max_blocks, bs=bs,
                   tail=cfg.kv_tail, cap_k=cap(cfg.kv_k_sparsity),
                   cap_v=cap(cfg.kv_v_sparsity),
                   device=resolve_device(device))

    @property
    def capacity_tokens(self) -> int:
        """Max context a slot may be admitted for (prefix storage alone)."""
        return self.max_blocks * self.bs

    def init_state(self) -> Dict[str, Any]:
        """Zeroed pool state.  Layer leaves carry a leading period axis:
        compressed ``[P, slots, Hkv, max_blocks, X]``, tails
        ``[P, slots, Hkv, tail, hd]``; bitmaps are int32 bit-views."""
        cfg = self.cfg
        n_periods = cfg.n_layers // lm.period_len(cfg)
        hkv, hd, dt = cfg.n_kv, cfg.hd, cfg.cdtype
        b, sb, w = self.slots, self.max_blocks, self.bs * hd // 32
        z = lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                             device=self.device)

        def kv_leaf():
            return {
                "k_bitmap": z((n_periods, b, hkv, sb, w), torch.int32),
                "k_values": z((n_periods, b, hkv, sb, self.cap_k), dt),
                "v_bitmap": z((n_periods, b, hkv, sb, w), torch.int32),
                "v_values": z((n_periods, b, hkv, sb, self.cap_v), dt),
                "k_tail": z((n_periods, b, hkv, self.tail, hd), dt),
                "v_tail": z((n_periods, b, hkv, self.tail, hd), dt),
            }
        return {
            "pos": z((b,), torch.int32),
            "prefix_blocks": z((b,), torch.int32),
            "tail_len": z((b,), torch.int32),
            "layers": {f"l{j}": {"kv": kv_leaf()}
                       for j in range(lm.period_len(cfg))},
        }

    def refreeze(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Fold every full tail into its slot's next free prefix blocks.

        Only full slots are compressed (the reference compresses every slot
        and keeps the full ones; the thresholds are per (slot, block), so
        the kept result is the same).  Slots whose tail is not full are
        untouched.  The caller guarantees no full slot overflows
        ``max_blocks`` (scheduler admission)."""
        cfg = self.cfg
        t, tb = self.tail, self.tail // self.bs
        full = (state["tail_len"] >= t).nonzero().flatten()
        if full.numel() == 0:
            return state
        offsets = state["prefix_blocks"][full].tolist()
        slots = full.tolist()
        for leaf in state["layers"].values():
            kv = leaf["kv"]
            p_, _, hkv, _, hd = kv["k_tail"].shape
            f = len(slots)
            flat = lambda a: a[:, full].reshape(p_ * f, hkv, t, hd)
            frozen = freeze_chunk_blocks(
                flat(kv["k_tail"]), flat(kv["v_tail"]),
                cfg.kv_k_sparsity, cfg.kv_v_sparsity, self.bs,
                self.cap_k, self.cap_v)
            for key, upd in zip(("k_bitmap", "k_values", "v_bitmap",
                                 "v_values"), frozen):
                upd = upd.reshape(p_, f, hkv, tb, -1)
                for n, (s, off) in enumerate(zip(slots, offsets)):
                    kv[key][:, s, :, off:off + tb] = upd[:, n].to(
                        kv[key].dtype)
        state["prefix_blocks"][full] += tb
        state["tail_len"][full] = 0
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
        their lengths; stale storage stays, fully masked.  Idempotent."""
        slot = torch.atleast_1d(torch.as_tensor(slot, dtype=torch.int32,
                                                device=self.device))
        rel = (slot[:, None] == torch.arange(
            self.slots, dtype=torch.int32, device=self.device)[None]).any(0)
        for key in ("pos", "prefix_blocks", "tail_len"):
            state[key].masked_fill_(rel, 0)
        return state
