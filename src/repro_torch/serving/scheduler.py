"""Request scheduler for the continuous-batching engine (host-side
bookkeeping; a copy of ``repro.serving.scheduler``, with the paged pool's
prefix index: :func:`block_hashes` and :class:`PrefixTrie`).

The scheduler owns the request lifecycle (queued -> prefilling ->
decoding -> finished), maps live requests onto pool slots, splits prompts
into block-aligned prefill chunks and recycles slots on completion.
Admission only takes a request whose worst case (prompt +
max_new_tokens) fits a slot's token capacity, so the refreeze scatter can
never overflow.  ``max_queue`` sheds submits past the bound; ``cancel`` /
``expire`` / ``defer_admission`` are the lifecycle exits the fault-tolerant
engine drives.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

from .sampling import RequestMetrics, RequestOutput, SamplingParams


@dataclasses.dataclass
class Request:
    """One generation request: immutable contract + scheduler-owned state."""
    rid: int
    prompt: List[int]
    params: SamplingParams
    # -- lifecycle state (scheduler-owned) --
    slot: int = -1
    prefill_done: int = 0            # prompt tokens already chunk-prefilled
    generated: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[Optional[float]] = dataclasses.field(default_factory=list)
    # None | "stop" | "length" | "shed" | "timeout" | "cancelled"
    finish_reason: Optional[str] = None
    arrival_time: float = 0.0
    admitted_time: Optional[float] = None    # queue -> pool slot
    first_token_time: Optional[float] = None
    finished_time: Optional[float] = None
    decode_ticks: int = 0            # engine decode steps consumed
    next_admit: float = 0.0          # earliest admit time (backoff requeue)
    backoff_s: float = 0.0           # current backoff interval

    @property
    def finished(self) -> bool:
        return self.finish_reason is not None

    @property
    def decoding(self) -> bool:
        return (self.slot >= 0 and not self.finished
                and self.prefill_done >= len(self.prompt))

    def output(self) -> RequestOutput:
        """Immutable snapshot of the current generation state."""
        return RequestOutput(
            request_id=self.rid,
            prompt_token_ids=tuple(self.prompt),
            token_ids=tuple(self.generated),
            finish_reason=self.finish_reason,
            metrics=RequestMetrics(self.arrival_time, self.first_token_time,
                                   self.finished_time,
                                   decode_ticks=self.decode_ticks,
                                   num_generated=len(self.generated),
                                   admitted_time=self.admitted_time),
            logprobs=tuple(self.logprobs))


def block_hashes(tokens: Sequence[int], bs: int) -> List[int]:
    """Chained content hashes of ``tokens``' full ``bs``-token blocks.

    ``h[i] = hash((h[i-1], block_i))``: each hash commits to the whole
    token prefix up to its block's end, so a flat ``hash -> block id`` dict
    behaves as a prefix trie — two prompts share hash ``i`` iff their first
    ``(i + 1) * bs`` tokens are identical.  A trailing partial block is not
    hashed: only frozen, block-aligned content is shareable.  (Hashes of
    tuples of ints do not depend on the interpreter's hash seed.)
    """
    out: List[int] = []
    parent = bs                      # domain-separate from user token values
    for i in range(len(tokens) // bs):
        parent = hash((parent, tuple(tokens[i * bs:(i + 1) * bs])))
        out.append(parent)
    return out


class PrefixTrie:
    """Host-side prefix index: chained block hash -> physical block id.

    Because the hashes chain (:func:`block_hashes`), a flat dict is a trie:
    :meth:`match` walks a prompt's hash list until the first miss, which is
    the longest shared block-aligned prefix already frozen in the arena.
    The trie owns no blocks: the :class:`~.cache_pool.BlockAllocator` counts
    references and evicts, and calls :meth:`drop` (its ``on_evict``) when a
    cached block's storage is reclaimed.
    """

    def __init__(self) -> None:
        self._map: Dict[int, int] = {}

    def match(self, hashes: Sequence[int]) -> List[int]:
        """Physical ids of the longest indexed prefix of ``hashes``."""
        ids: List[int] = []
        for h in hashes:
            bid = self._map.get(h)
            if bid is None:
                break
            ids.append(bid)
        return ids

    def insert(self, h: int, bid: int) -> None:
        self._map.setdefault(h, bid)     # first writer wins

    def drop(self, h: int) -> None:
        self._map.pop(h, None)

    def reload(self, items) -> None:
        """Replace the whole index (a warm restart).  In place, so the
        allocator's ``on_evict`` keeps pointing at the live object.  The
        chained hashes are Python's ``hash`` of int tuples, the same in
        every process, so a saved index stays valid."""
        self._map = dict(items)

    def items(self):
        return self._map.items()

    def __len__(self) -> int:
        return len(self._map)


def _matches_stop(generated: List[int],
                  stop_ids: Sequence[Sequence[int]]) -> bool:
    """True if the generated tail equals any stop sequence."""
    return any(len(generated) >= len(s)
               and generated[len(generated) - len(s):] == list(s)
               for s in stop_ids)


class Scheduler:
    """Maps requests onto ``slots`` pool slots with chunked prefill.

    ``chunk`` is the max prompt tokens prefill processes per engine tick
    (rounded down to a block multiple for every chunk but the last, so the
    pool's frozen prefix stays block-aligned).  ``capacity_tokens`` is the
    pool's per-slot limit used for admission.  ``max_queue`` bounds the
    admission queue (0 = unbounded): a submit past the bound is shed.
    ``backoff_base`` / ``backoff_cap`` shape the exponential requeue delay
    applied by :meth:`defer_admission`.
    """

    def __init__(self, slots: int, capacity_tokens: int, bs: int,
                 chunk: Optional[int] = None,
                 clock=time.monotonic, max_queue: int = 0,
                 backoff_base: float = 0.005, backoff_cap: float = 0.25):
        if chunk is not None and chunk < bs:
            raise ValueError(f"prefill chunk {chunk} < block size {bs}")
        self.slots = slots
        self.capacity_tokens = capacity_tokens
        self.bs = bs
        self.chunk = (chunk // bs * bs) if chunk else None
        self.clock = clock
        self.max_queue = max_queue
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}          # slot -> request
        self.finished: Dict[int, Request] = {}        # rid -> request
        self._next_rid = 0
        # sheds happen HERE (the queue bound is scheduler state), so the
        # scheduler owns the authoritative count; layers above mirror it
        # instead of incrementing their own, which keeps shed accounting
        # single-sourced no matter how many frontends submit
        self.shed_count = 0

    # -- submission ---------------------------------------------------------
    def submit(self, prompt: List[int],
               params: Optional[SamplingParams] = None) -> int:
        """Queue a request; returns its id.  Raises if it can never fit.

        With ``max_queue`` set and the queue full, the request is **shed**:
        it goes straight to ``finished`` with ``finish_reason="shed"``,
        holding no slot, no pages, and no queue position — load shedding
        rejects new work before it can degrade live traffic.  Callers
        distinguish the outcome by the returned request's finish reason,
        not by an exception (shedding is a normal overload response).
        """
        params = params if params is not None else SamplingParams()
        if not prompt:
            raise ValueError("empty prompt")
        need = len(prompt) + params.max_new_tokens
        if need > self.capacity_tokens:
            raise ValueError(
                f"request needs {need} tokens; pool slots hold "
                f"{self.capacity_tokens}")
        rid = self._next_rid
        self._next_rid += 1
        now = self.clock()
        req = Request(rid, list(prompt), params, arrival_time=now)
        if self.max_queue and len(self.queue) >= self.max_queue:
            # shed at submit time: admitted_time stays None (the request
            # was never admitted — queue-time metrics must not invent a
            # zero-length admission) and the scheduler's own counter is
            # the one counter path
            req.finish_reason = "shed"
            req.finished_time = now
            self.finished[rid] = req
            self.shed_count += 1
        else:
            self.queue.append(req)
        return rid

    # -- per-tick queries ---------------------------------------------------
    def free_slots(self) -> List[int]:
        return [s for s in range(self.slots) if s not in self.active]

    def admit(self, now: Optional[float] = None) -> Optional[Request]:
        """Move the oldest queued request into a free slot (if any).

        A head backing off after :meth:`defer_admission` is not admitted
        before its ``next_admit`` time — and, to keep FIFO order, nothing
        behind it is either.
        """
        now = self.clock() if now is None else now
        if not self.queue:
            return None
        if self.queue[0].next_admit > now:
            return None
        free = self.free_slots()
        if not free:
            return None
        req = self.queue.popleft()
        req.slot = free[0]
        req.admitted_time = now
        self.active[req.slot] = req
        return req

    def defer_admission(self, now: Optional[float] = None) -> float:
        """Back off the queue head after a failed admission attempt (paged
        page-reservation shortfall).  Doubles the head's backoff interval
        (from ``backoff_base`` up to ``backoff_cap``) and stamps its
        ``next_admit``; returns the interval.  Head-of-line only — FIFO
        order is preserved, later requests simply wait behind the head.
        """
        now = self.clock() if now is None else now
        req = self.queue[0]
        req.backoff_s = min(self.backoff_cap,
                            max(self.backoff_base, req.backoff_s * 2))
        req.next_admit = now + req.backoff_s
        return req.backoff_s

    # -- lifecycle exits ----------------------------------------------------
    def _finish_abnormal(self, req: Request, reason: str,
                         now: float) -> None:
        req.finish_reason = reason
        req.finished_time = now
        self.finished[req.rid] = req

    def cancel(self, rid: int, now: Optional[float] = None
               ) -> Optional[Request]:
        """Cancel a request wherever it lives; returns it if state changed.

        Queued: removed from the queue.  Active (prefilling or decoding):
        removed from ``active`` — the caller owns releasing its slot
        (``req.slot >= 0`` distinguishes this case).  Already finished
        (or unknown rid): no-op, returns ``None`` — cancellation racing
        normal completion loses quietly.
        """
        now = self.clock() if now is None else now
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                self._finish_abnormal(req, "cancelled", now)
                return req
        for slot, req in list(self.active.items()):
            if req.rid == rid:
                del self.active[slot]
                self._finish_abnormal(req, "cancelled", now)
                return req
        return None

    def expire(self, now: Optional[float] = None) -> List[Request]:
        """Finish every request whose deadline has passed with
        ``finish_reason="timeout"``; returns them (callers release the
        slots of those with ``req.slot >= 0``).

        Two deadlines per request, both measured from arrival:
        ``params.ttft_deadline_s`` fires only while no token has been
        produced; ``params.deadline_s`` bounds total wall clock.  Queued
        requests expire too (a request that waited out its whole deadline
        in the queue never deserves a slot).  Runs at tick *start*, so a
        stop committed last tick already finished the request — committed
        output always beats a later deadline check.
        """
        now = self.clock() if now is None else now
        expired: List[Request] = []
        for slot, req in list(self.active.items()):
            if self._deadline_passed(req, now):
                del self.active[slot]
                self._finish_abnormal(req, "timeout", now)
                expired.append(req)
        for req in list(self.queue):
            if self._deadline_passed(req, now):
                self.queue.remove(req)
                self._finish_abnormal(req, "timeout", now)
                expired.append(req)
        return expired

    @staticmethod
    def _deadline_passed(req: Request, now: float) -> bool:
        p = req.params
        waited = now - req.arrival_time
        if p.deadline_s is not None and waited >= p.deadline_s:
            return True
        return (p.ttft_deadline_s is not None
                and req.first_token_time is None
                and waited >= p.ttft_deadline_s)

    def next_prefill(self) -> Optional[Request]:
        """The request owed a prefill chunk this tick (oldest first)."""
        for req in sorted(self.active.values(), key=lambda r: r.rid):
            if req.prefill_done < len(req.prompt):
                return req
        return None

    def prefill_chunk(self, req: Request) -> List[int]:
        """Slice the next chunk off ``req``'s prompt and mark it done.

        Every chunk except the last is a multiple of ``bs`` (the frozen
        prefix grows whole blocks); the final chunk carries the remainder
        into the dense tail.
        """
        left = len(req.prompt) - req.prefill_done
        take = left if self.chunk is None else min(self.chunk, left)
        if take < left:                   # not final: keep block-aligned
            take = take // self.bs * self.bs
        chunk = req.prompt[req.prefill_done:req.prefill_done + take]
        req.prefill_done += take
        return chunk

    def decoding_slots(self) -> List[int]:
        return [s for s, r in self.active.items() if r.decoding]

    # -- completion ---------------------------------------------------------
    def record_token(self, slot: int, token: int,
                     logprob: Optional[float] = None) -> Optional[str]:
        """Single-token convenience wrapper over :meth:`record_tokens`."""
        return self.record_tokens(
            slot, [token], None if logprob is None else [logprob])

    def record_tokens(self, slot: int, tokens: Sequence[int],
                      logprobs: Optional[Sequence[Optional[float]]] = None,
                      decode_tick: bool = True) -> Optional[str]:
        """Commit the window of tokens one engine tick produced for a slot
        (one token on the plain path; up to K+1 under speculation).

        The stop scan runs *inside* the window: each token is appended and
        checked in order, and the first eos / stop-sequence / budget hit
        truncates the commit — tokens past it are discarded, exactly as if
        the non-speculative engine had stopped there (speculatively
        verified tokens crossing a stop must never leak into the output).
        A stop hit on the budget's last token wins over "length".

        Returns the finish reason (``"stop"`` | ``"length"`` | None);
        finishing releases the slot for re-admission.  ``decode_tick=False``
        (prefill's first token) leaves the tick counter untouched so
        ``accepted_per_tick`` measures decode work only.  ``logprobs`` are
        the device sampler's chosen-token log-probabilities (surfaced on
        ``RequestOutput.logprobs``); host-only callers may omit them.
        """
        req = self.active[slot]
        now = self.clock()
        if req.first_token_time is None:
            req.first_token_time = now
        if decode_tick:
            req.decode_ticks += 1
        p = req.params
        reason = None
        for i, token in enumerate(tokens):
            token = int(token)
            req.generated.append(token)
            req.logprobs.append(None if logprobs is None else logprobs[i])
            if ((p.eos_id is not None and token == p.eos_id)
                    or _matches_stop(req.generated, p.stop_ids)):
                reason = "stop"
            elif len(req.generated) >= p.max_new_tokens:
                reason = "length"
            if reason is not None:
                break                      # truncate: drop the window's rest
        if reason is not None:
            req.finish_reason = reason
            req.finished_time = now
            del self.active[slot]
            self.finished[req.rid] = req
        return reason

    def done(self) -> bool:
        return not self.queue and not self.active
