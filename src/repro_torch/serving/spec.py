"""Speculative decoding for the continuous-batching engine, draft-verify
(a copy of ``repro.serving.spec``, numpy only).

Token generation is bound by the bytes each decode tick reads: the whole
weight set plus each slot's cache, for ONE token per slot.  Speculation
spreads that read over several tokens: a cheap *drafter* proposes up to
``K`` continuation tokens per slot, and one **verify** forward scores all
``K+1`` positions at once (a query panel through the same fused attention
kernel).  Accepted drafts commit as a window; rejected ones are un-appended
by a length rollback on the pooled cache.  Greedy lanes stay
token-identical to the plain engine, and sampled lanes keep their output
distribution through rejection sampling
(:func:`repro_torch.serving.sampling.accept_step`).

The drafter is model-free: n-gram prompt lookup over each request's own
history (prompt + generated).  It wins where serving is repetitive (code,
extraction, templated text) and proposes nothing elsewhere, where the slot
then commits one token per tick.  Any other drafter can stand behind the
same :class:`Drafter` protocol.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np


@runtime_checkable
class Drafter(Protocol):
    """Anything that proposes draft continuations from a token history."""

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        """Up to ``k`` draft tokens continuing ``history`` (may be empty —
        the engine pads short/absent proposals with invalid lanes)."""
        ...


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs for ``ContinuousEngine``.

    k: max draft tokens verified per slot per tick (the verify panel is
      ``k + 1`` wide).  ``k == 0`` disables speculation outright.
    enabled: master switch — ``False`` preserves the non-speculative
      engine bit-for-bit (the verify step is never even built).
    max_ngram/min_ngram: suffix n-gram lengths the default prompt-lookup
      drafter tries, longest first.
    drafter: optional :class:`Drafter` override; ``None`` builds an
      :class:`NGramDrafter` from the n-gram bounds.
    adaptive: per-slot adaptive draft K — each slot's *recent acceptance
      rate* (EMA, decay ``adapt_decay``) scales its next draft window
      within ``[adapt_min_k, k]``.  Host-side data only: the verify panel
      stays ``[slots, k+1]`` wide whatever each slot proposes, so every
      verify launches the same kernels at the same shapes.  Outputs are
      unchanged too — acceptance is per token, so proposing fewer drafts
      never changes *which* tokens commit, only how many ride one tick.
    adapt_decay: EMA decay of the per-slot acceptance-rate estimate
      (weight on the past; 0 = last tick only).
    adapt_min_k: floor of the adaptive window — a cold or unlucky slot
      keeps probing with at least this many drafts.
    """

    k: int = 4
    enabled: bool = True
    max_ngram: int = 3
    min_ngram: int = 1
    drafter: Optional[Drafter] = None
    adaptive: bool = False
    adapt_decay: float = 0.75
    adapt_min_k: int = 1

    def __post_init__(self):
        if self.k < 0:
            raise ValueError(f"k must be >= 0: {self.k}")
        if not 1 <= self.min_ngram <= self.max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram: "
                f"{self.min_ngram}, {self.max_ngram}")
        if not 0.0 <= self.adapt_decay < 1.0:
            raise ValueError(
                f"adapt_decay must be in [0, 1): {self.adapt_decay}")
        if self.adaptive and self.k and not 1 <= self.adapt_min_k <= self.k:
            raise ValueError(
                f"need 1 <= adapt_min_k <= k: {self.adapt_min_k}, {self.k}")

    @property
    def active(self) -> bool:
        return self.enabled and self.k > 0

    def build_drafter(self) -> Drafter:
        if self.drafter is not None:
            return self.drafter
        return NGramDrafter(max_ngram=self.max_ngram,
                            min_ngram=self.min_ngram)


class AdaptiveDraft:
    """Per-slot adaptive draft-length controller (host-side).

    Keeps an EMA of each slot's draft acceptance rate and maps it onto a
    draft window in ``[min_k, k]``: a slot whose history keeps verifying
    speculates at full depth, one whose drafts keep getting rejected backs
    off to the floor (rejected drafts are cheap — a rollback — but they
    widen the verify panel's *useful* fraction, so proposing fewer on cold
    streams keeps accept-rate statistics honest in the spec histogram).
    Ticks where a slot proposed nothing (no n-gram hit / no tail headroom)
    carry no acceptance evidence and leave the estimate untouched.

    Pure ints/floats per slot; the engine resets a slot's estimate when
    its request finishes so the next tenant starts fresh (optimistic at
    full ``k`` — the first tick probes).
    """

    def __init__(self, spec: "SpecConfig"):
        self.k = spec.k
        self.min_k = min(spec.adapt_min_k, spec.k) if spec.k else 0
        self.decay = spec.adapt_decay
        self._rate: dict = {}                 # slot -> EMA acceptance rate
        self.hist = np.zeros(spec.k + 1, np.int64)

    def draft_len(self, slot: int) -> int:
        """The slot's current draft window: ``min_k + rate * (k - min_k)``
        rounded; optimistic full-``k`` until the first evidence arrives."""
        rate = self._rate.get(slot)
        if rate is None:
            return self.k
        return self.min_k + int(round(rate * (self.k - self.min_k)))

    def update(self, slot: int, proposed: int, accepted: int) -> None:
        """Fold one verify tick's outcome into the slot's estimate."""
        self.hist[max(0, min(proposed, self.k))] += 1
        if proposed <= 0:
            return                            # no evidence this tick
        rate = min(max(accepted / proposed, 0.0), 1.0)
        prev = self._rate.get(slot)
        self._rate[slot] = rate if prev is None else \
            self.decay * prev + (1.0 - self.decay) * rate

    def reset(self, slot: int) -> None:
        self._rate.pop(slot, None)


class NGramDrafter:
    """Prompt-lookup drafter: continue the most recent earlier occurrence
    of the history's longest matching suffix n-gram.

    Tries suffix lengths ``max_ngram`` down to ``min_ngram``; for the
    first length whose suffix recurs earlier in the history, proposes the
    ``k`` tokens that followed the most recent match.  Pure host-side
    Python over ints — O(len(history)) per proposal, no device work, no
    model state.  Returns ``[]`` when nothing matches (the slot simply
    decodes non-speculatively that tick).
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        assert 1 <= min_ngram <= max_ngram, (min_ngram, max_ngram)
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        hist = list(history)
        if k <= 0 or len(hist) < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, len(hist) - 1),
                       self.min_ngram - 1, -1):
            suffix = hist[-n:]
            # most recent occurrence strictly before the suffix itself
            for start in range(len(hist) - n - 1, -1, -1):
                if hist[start:start + n] == suffix:
                    cont = hist[start + n:start + n + k]
                    if cont:
                        return [int(t) for t in cont]
        return []
