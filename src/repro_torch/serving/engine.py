"""Continuous-batching serving engine on the pooled sparse-KV cache (twin of
``repro.serving.engine.ContinuousEngine`` with no mesh, no fault injection
and no telemetry; the flat pool or, with ``paged=True``, the shared-prefix
paged pool; speculative decoding with ``spec=SpecConfig(k)``; serial or,
with ``overlap=True``, overlapped ticks).

One engine tick (:meth:`step`):

1. **refreeze** — every slot whose tail ring is full has its tail pruned
   and folded into its compressed prefix, in place;
2. **admission / chunked prefill** — admitted requests get their sampling
   lane; the oldest request owed prompt work gets one chunk prefilled
   against its slot's frozen prefix, and the final chunk samples the
   request's first token;
3. **decode** — every decoding slot advances one token in one batched
   panel forward (``Q == 1``) and the sampler draws each slot's token
   under its own lane.

Host <-> device traffic per tick is one token vector and one chosen-token
logprob vector; slot lengths are mirrored on the host.  Arguments that
belong to later slices of the port raise ``NotImplementedError``.

**Captured forwards** (the twin of the reference's ``jax.jit`` entries,
``engine.py:401-424``).  The decode forward (``[slots, 1]``) and the verify
forward (``[slots, k+1]``) each run through one :class:`PanelGraph` per
engine: static token and slot-mask inputs, one static logits output, and
on CUDA a ``torch.cuda.CUDAGraph`` captured once and replayed every tick,
so a tick costs one graph launch instead of thousands of kernel launches.
The graph reads the pool's state tensors in place, and every pool
transition updates those same storages, so refreeze, admission, rollback
and release never need a new capture; :meth:`ContinuousEngine.trace_counts`
holds it at one capture per entry.  The sampler, the verify's accept and
rollback, refreeze and the prefill chunk stay eager.  ``graphs=False``
runs the same forwards eagerly (the twin of ``jax.disable_jit()``).

**Overlapped ticks** (``overlap=True``, the twin of the reference's
``_overlap_decode_tick`` / ``_sync_inflight``).  Tick t+1's decode is
enqueued before tick t's tokens reach the host: its input is tick t's
token vector on the device, overridden from the host only where the chain
breaks.  Under speculation the pipeline is shallow: the verify enqueued
last tick commits after this tick's prefill dispatch and before its
refreeze and drafting.  :meth:`ContinuousEngine._sync_inflight` is the one
place a tick's tokens reach the host; it re-checks ``(slot, rid)``, so a
window dispatched for a request that finished meanwhile is dropped.
:meth:`ContinuousEngine.quiesce` drains the pipeline.

Speculation (``spec=SpecConfig(k>0)``) turns the decode tick into a
draft-verify tick: the host drafter proposes up to ``k`` tokens per slot
from the request's own history (clamped to the slot's tail headroom), one
``[slots, k+1]`` panel forward scores every position, ``accept_step``
accepts per lane, and the pool rolls the rejected suffix back by a length
decrement.  The panel runs through the same attention kernel as a decode
tick, with ``(k+1) * G`` query rows; any ``k >= 0`` is taken, as in the
reference.

Paged pool: a host :class:`~.cache_pool.BlockAllocator` hands out physical
block ids and a :class:`~.scheduler.PrefixTrie` indexes the blocks frozen
by full-width prefill chunks under their chained content hashes.
Admission reserves each request's worst-case page demand (deferring the
queue head with backoff when the arena cannot cover it) and points a
prompt's already-frozen prefix at the shared blocks, skipping its prefill.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import kernels, resolve_device
from repro_torch.models import lm
from . import sampling
from .cache_pool import BlockAllocator, CachePool
from .sampling import RequestOutput, SamplingParams
from .scheduler import PrefixTrie, Scheduler, block_hashes
from .spec import AdaptiveDraft, SpecConfig


def params_to(tree: Any, device: torch.device) -> Any:
    """Move a params tree (tensors and sparse weights) to ``device``."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def stable_trace_counts(counts: Dict[str, int],
                        ignore: tuple = ("prefill_chunk",)) -> Dict[str, int]:
    """The entries of :meth:`ContinuousEngine.trace_counts` that must stay
    flat after warm-up (twin of the reference's ``stable_trace_counts``;
    the port captures no prefill chunk, so the filter only mirrors it)."""
    return {k: v for k, v in counts.items() if k not in ignore}


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _counted(fn: Callable[[], Any]):
    """Run ``fn``; returns its output and the launches each kernel wrapper
    counted meanwhile, with every counter put back as it was."""
    before = kernels.launch_counts()
    out = fn()
    after = kernels.launch_counts()
    kernels.set_launch_counts(before)
    return out, {k: n - before[k] for k, n in after.items()
                 if n != before[k]}


class PanelGraph:
    """One panel forward over the pool at a fixed width ``Q``: the port's
    counterpart of a jitted entry compiled once.

    Static inputs ``tokens`` (int64 ``[B, Q]``) and ``mask`` (bool ``[B]``)
    and one static output ``logits`` (f32 ``[B, Q, V]``), read and written
    in place; ``params`` and ``state`` are read (and the state's tails and
    lengths updated) where they lie.  On CUDA the forward is captured once
    as a ``torch.cuda.CUDAGraph`` after one eager warm-up on a side stream,
    so that every kernel's first launch, the kernels' per-device scratch
    and the plans are made outside the capture; the warm-up runs with an
    all-false mask, which writes nothing.  Each :meth:`run` replays the
    graph and adds the kernel launches it holds to the wrappers' counters.
    On the CPU the capture and each replay call the forward on the static
    inputs and copy its logits into the same output tensor, with the same
    warm-up and launch accounting.  ``eager=True`` calls the forward each
    run and returns fresh logits (no capture).

    A replay after a state tensor was replaced by another raises: the
    graph would read storage that is no longer the pool's."""

    def __init__(self, params, state: Dict[str, Any], cfg, bs: int,
                 qn: int, eager: bool = False):
        dev = state["pos"].device
        b = state["pos"].shape[0]
        self.tokens = torch.zeros((b, qn), dtype=torch.long, device=dev)
        self.mask = torch.zeros(b, dtype=torch.bool, device=dev)
        self._mask_key = (False,) * b
        self._state, self._leaves = state, _leaves(state)
        self._fn = lambda: lm.forward_panel_pooled(
            params, state, self.tokens, self.mask, cfg, bs)[0]
        self.eager = eager
        self.captures = self.replays = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.held: Dict[str, int] = {}      # kernel launches one run holds
        if not eager:
            self._capture()

    def _capture(self) -> None:
        if self.tokens.is_cuda:
            side = torch.cuda.Stream(self.tokens.device)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._fn()
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.logits, self.held = _counted(self._fn)
        else:
            self._fn()
            self.logits, self.held = _counted(self._fn)
        self.captures += 1

    def set_inputs(self, tokens: torch.Tensor, mask: Sequence[bool]) -> None:
        """Write the panel (host or device, ``[B, Q]``) and the slot mask
        into the static inputs without waiting for the device; the mask is
        copied only when it changed."""
        self.tokens.copy_(tokens, non_blocking=True)
        key = tuple(bool(m) for m in mask)
        if key != self._mask_key:
            self.mask.copy_(torch.tensor(key), non_blocking=True)
            self._mask_key = key

    def run(self) -> torch.Tensor:
        """The forward on the current inputs; returns ``logits``, which the
        next run overwrites (in eager mode, fresh logits)."""
        self.replays += 1
        if self.eager:
            return self._fn()
        now = _leaves(self._state)
        if len(now) != len(self._leaves) or any(
                a is not b for a, b in zip(now, self._leaves)):
            raise RuntimeError("a pool state tensor was replaced since the "
                               "capture; transitions must update in place")
        if self.graph is not None:
            self.graph.replay()
        else:
            out, _ = _counted(self._fn)
            self.logits.copy_(out)
        for name, n in self.held.items():
            kernels.KERNELS[name].launches += n
        return self.logits


class ContinuousEngine:
    """Continuous-batching engine: requests stream through a
    :class:`CachePool` of fixed-geometry slots under a :class:`Scheduler`;
    chunked prefill interleaves with decode ticks and slots recycle on
    completion.  Runs on the CUDA device unless ``device="cpu"``.

    ``overlap=True`` enqueues each tick before the previous tick's tokens
    reach the host; greedy and seeded output are identical either way.
    ``graphs=False`` runs the decode and verify forwards eagerly instead of
    through their captured :class:`PanelGraph` (tests and oracles only)."""

    def __init__(self, params, cfg, slots: int = 4, max_tokens: int = 0,
                 bs: int = 0, prefill_chunk: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 device: Optional[torch.device] = None, *,
                 ctx=None, spec=None, mesh=None, paged: bool = False,
                 phys_blocks: int = 0, checkify: Optional[bool] = None,
                 capacity_slack: Optional[float] = None, max_queue: int = 0,
                 degrade_queue: int = 0, faults=None, obs=None,
                 overlap: bool = False, graphs: bool = True):
        later = {"ctx": ctx is not None, "mesh": mesh is not None,
                 "checkify": bool(checkify),
                 "capacity_slack": capacity_slack is not None,
                 "max_queue": bool(max_queue),
                 "degrade_queue": bool(degrade_queue),
                 "faults": faults is not None, "obs": obs is not None}
        unported = [k for k, v in later.items() if v]
        if unported:
            raise NotImplementedError(
                f"ContinuousEngine options {unported} belong to later "
                "slices of the port")
        self.device = resolve_device(device)
        self.cfg = cfg
        max_tokens = max_tokens or 4 * cfg.kv_tail
        if not bs:
            # largest tail divisor <= min(128, prefill_chunk): chunks stay
            # block-aligned and the tail folds in whole blocks
            limit = min(128, prefill_chunk or 128, cfg.kv_tail)
            bs = next(d for d in range(limit, 0, -1)
                      if cfg.kv_tail % d == 0)
        self.pool = CachePool.build(cfg, slots, max_tokens, bs=bs,
                                    device=self.device, paged=paged,
                                    n_phys=phys_blocks)
        self.state = self.pool.init_state()
        self.lanes = sampling.init_lanes(slots, self.device)
        # per-slot request generators (sampled requests only) and whether
        # the slot's request needs the sampler's exact sort (host copy of
        # the masker's branch, so the sampler never waits for the device)
        self._gens: List[Optional[torch.Generator]] = [None] * slots
        self._exact = [False] * slots
        self.params = params_to(params, self.device)
        sch_kw = {} if clock is None else {"clock": clock}
        self.scheduler = Scheduler(slots, self.pool.capacity_tokens,
                                   self.pool.bs, chunk=prefill_chunk,
                                   **sch_kw)
        # host mirrors (avoid a device sync per tick)
        self._tail_len = np.zeros(slots, np.int64)
        self._last_tok: Dict[int, int] = {}
        self._callbacks: Dict[int, Callable[[RequestOutput], None]] = {}
        self._pending_release: List[int] = []
        self._slot_live = np.zeros(slots, bool)
        # paged pool: host-side id lifecycle + prefix index.  Sharing needs
        # deterministic block content, which needs deterministic chunk
        # boundaries: the trie indexes only blocks frozen by full-width
        # chunks, so it is active iff prefill is chunked.
        self._trie = PrefixTrie() if paged else None
        self._alloc = (BlockAllocator(self.pool.n_phys,
                                      on_evict=self._trie.drop)
                       if paged else None)
        self._blocks: Dict[int, List[int]] = {}       # slot -> table row ids
        self._reserved: Dict[int, int] = {}           # slot -> pages owed
        # speculative decoding: the host drafter, the accepted-draft
        # histogram and (adaptive) the per-slot draft-length controller
        self._spec: Optional[SpecConfig] = (
            spec if spec is not None and spec.active else None)
        self._adaptive: Optional[AdaptiveDraft] = None
        if self._spec is not None:
            self.drafter = self._spec.build_drafter()
            self.spec_hist = np.zeros(self._spec.k + 1, np.int64)
            if self._spec.adaptive:
                self._adaptive = AdaptiveDraft(self._spec)
        # the captured forwards, one per entry, made at first use
        self._graphs = bool(graphs)
        self._entries: Dict[str, PanelGraph] = {}
        # the overlapped pipeline: the dispatched, not yet committed tick
        self.overlap = bool(overlap)
        self._inflight: Optional[Dict[str, Any]] = None

    # -- public API ---------------------------------------------------------
    def submit(self, prompt, params: Optional[SamplingParams] = None,
               on_token: Optional[Callable[[RequestOutput], None]] = None
               ) -> int:
        """Queue a request under its own :class:`SamplingParams`; returns
        the request id.  ``on_token`` gets a snapshot per committed token."""
        if params is not None and (params.deadline_s is not None
                                   or params.ttft_deadline_s is not None):
            raise NotImplementedError("request deadlines are not ported yet")
        toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
        rid = self.scheduler.submit(toks, params)
        if on_token is not None:
            self._callbacks[rid] = on_token
        return rid

    def run(self) -> Dict[int, RequestOutput]:
        """Tick until every submitted request finished."""
        while not self.scheduler.done():
            self.step()
        self.quiesce()
        return {rid: req.output()
                for rid, req in self.scheduler.finished.items()}

    def stream(self) -> Iterator[RequestOutput]:
        """Tick until the queue drains, yielding a snapshot per token."""
        while not self.scheduler.done():
            yield from self.step()
        yield from self.quiesce()

    def quiesce(self) -> List[RequestOutput]:
        """Drain the overlapped pipeline: commit (or, for requests that
        finished meanwhile, drop) the in-flight tick's window and flush the
        pending releases.  A no-op on the serial engine; returns the
        snapshots it committed."""
        events: List[RequestOutput] = []
        self._sync_inflight(events)
        self._flush_releases()
        return events

    def trace_counts(self) -> Dict[str, int]:
        """Captures per forward entry (twin of the reference's jit trace
        counts): ``decode``, and ``verify`` under speculation.  One each
        once warm, whatever refreezes, admissions and releases came
        between; 0 for an entry not run yet and under ``graphs=False``."""
        names = ["decode"] + (["verify"] if self._spec is not None else [])
        return {n: (self._entries[n].captures if n in self._entries else 0)
                for n in names}

    def replay_counts(self) -> Dict[str, int]:
        """Runs per forward entry (graph replays, or eager forwards under
        ``graphs=False``): the engine's decode and verify ticks."""
        return {n: e.replays for n, e in self._entries.items()}

    def _entry(self, name: str) -> PanelGraph:
        """The entry's forward (``decode``: ``[slots, 1]``; ``verify``:
        ``[slots, k+1]``), captured at its first use."""
        fwd = self._entries.get(name)
        if fwd is None:
            qn = 1 if name == "decode" else self._spec.k + 1
            fwd = self._entries[name] = PanelGraph(
                self.params, self.state, self.cfg, self.pool.bs, qn,
                eager=not self._graphs)
        return fwd

    def _panel_logits(self, name: str, tokens: torch.Tensor,
                      mask: Sequence[bool]) -> torch.Tensor:
        """One ``[slots, Q]`` panel forward through entry ``name`` on
        ``tokens`` (host or device) and the slot mask; every live slot's
        ``Q`` tokens are appended to its tail.  Returns the logits (the
        entry's static output: read them before the entry runs again)."""
        fwd = self._entry(name)
        fwd.set_inputs(tokens, mask)
        return fwd.run()

    def _exact_for(self, live: Sequence[bool]) -> bool:
        return any(self._exact[s] for s in range(self.pool.slots)
                   if live[s] and self._gens[s] is not None)

    def generate_batch(self, prompts, params: Optional[SamplingParams] = None
                       ) -> np.ndarray:
        """Submit every row of ``prompts [B, S]`` under one ``params``;
        returns ``[B, max_new_tokens]`` int32 tokens."""
        params = params if params is not None else SamplingParams()
        rids = [self.submit(row, params) for row in np.asarray(prompts)]
        out = self.run()
        return np.asarray([out[r].token_ids for r in rids], np.int32)

    @property
    def adaptive_hist(self) -> Optional[np.ndarray]:
        """Per-tick draft proposals of ``SpecConfig(adaptive=True)`` (index
        = drafts a slot put up for verification that tick); None when
        adaptive K is off."""
        return None if self._adaptive is None else self._adaptive.hist

    # -- one tick -----------------------------------------------------------
    def step(self) -> List[RequestOutput]:
        """Advance one tick; returns a snapshot per token emitted.  Slots
        freed this tick are released together at its end."""
        try:
            return self._step_inner()
        finally:
            self._flush_releases()

    def _flush_releases(self) -> None:
        if not self._pending_release:
            return
        seen = list(dict.fromkeys(self._pending_release))
        self._pending_release = []
        for s in seen:
            self._slot_live[s] = False
            self._gens[s] = None
        vec = torch.full((self.pool.slots,), -1, dtype=torch.int32)
        vec[:len(seen)] = torch.tensor(seen, dtype=torch.int32)
        self.pool.release(self.state, vec.to(self.device, non_blocking=True))
        if self._alloc is not None:
            for s in seen:
                ids = self._blocks.pop(s, [])
                if ids:
                    self._alloc.decref(ids)
                self._reserved.pop(s, None)

    def _admit_paged(self, now: float):
        """Reservation + prefix-hit admission of the queue's head.

        Returns the admitted request, or None (the request stays queued,
        backing off) when the arena cannot guarantee its worst-case page
        demand on top of every admitted request's outstanding reservation —
        the paged analogue of running out of slots.  On admission a
        prefix-trie hit points the slot's table row at the shared blocks
        and skips their prefill."""
        sch, bs, alloc = self.scheduler, self.pool.bs, self._alloc
        nxt = sch.queue[0]
        plen = len(nxt.prompt)
        hits: List[int] = []
        if sch.chunk is not None:
            hits = self._trie.match(block_hashes(nxt.prompt, bs))
            # a full-prompt hit would leave no token to produce the first
            # logits; hits are quantised down to whole chunks so the rest
            # of the prefill keeps the chunk boundaries the shared blocks
            # were hashed under
            cw = sch.chunk // bs
            n_hit = min(len(hits), (plen - 1) // bs) // cw * cw
            hits = hits[:n_hit]
        revived = sum(1 for i in hits if alloc.refcount(i) == 0)
        need = -(-(plen + nxt.params.max_new_tokens) // bs) - len(hits)
        outstanding = sum(self._reserved.values())
        if need + revived + outstanding > alloc.free_blocks():
            sch.defer_admission(now)       # head-of-line: FIFO preserved
            return None
        req = sch.admit(now)
        self._reserved[req.slot] = need
        self._blocks[req.slot] = list(hits)
        if hits:
            alloc.incref(hits)
            self.pool.assign_blocks(self.state, req.slot, hits, len(hits))
            req.prefill_done = len(hits) * bs   # shared prefix: no prefill
            self._tail_len[req.slot] = 0
        return req

    def _step_inner(self) -> List[RequestOutput]:
        events: List[RequestOutput] = []
        sch = self.scheduler
        now = sch.clock()
        while sch.queue and sch.free_slots():
            if sch.queue[0].next_admit > now:
                break                          # head backing off: FIFO waits
            req = (sch.admit(now) if self._alloc is None
                   else self._admit_paged(now))
            if req is None:
                break                          # arena full: wait for releases
            sampling.set_lane(self.lanes, req.slot, req.params)
            self._gens[req.slot] = (
                sampling.request_generator(req.params, self.device)
                if req.params.temperature > 0 else None)
            self._exact[req.slot] = sampling.needs_exact_sort(
                req.params, self.cfg.vocab)
            self._slot_live[req.slot] = True

        if self.overlap and self._spec is not None:
            # the shallow pipeline: the verify enqueued last tick commits
            # after this tick's prefill dispatch and before the refreeze
            # decision (the tail mirrors need its accept counts) and the
            # drafting (the drafter reads the committed history)
            self._prefill_tick(events)
            self._sync_inflight(events)
            self._refreeze_tick(events)
            slots = sch.decoding_slots()
            if not slots:
                return events
            return self._spec_tick(slots, events)

        # under overlap the tail mirrors are exact here: a decode appends
        # one token, applied at its dispatch
        self._refreeze_tick(events)
        self._prefill_tick(events)

        slots = sch.decoding_slots()
        if not slots:
            if self.overlap:
                self._sync_inflight(events)     # the pipeline drains idle
            return events
        if self._spec is not None:
            return self._spec_tick(slots, events)
        if self.overlap:
            return self._overlap_decode_tick(slots, events)
        b = self.pool.slots
        tokens = torch.zeros((b, 1), dtype=torch.long)
        mask = [False] * b
        for s in slots:
            tokens[s, 0] = self._last_tok[s]
            mask[s] = True
        logits = self._panel_logits("decode", tokens, mask)
        tok, logp = sampling.sample_step(logits[:, 0], self.lanes,
                                         self._gens, mask,
                                         self._exact_for(mask))
        picked, logps = tok.tolist(), logp.tolist()
        for s in slots:
            if s not in sch.active:
                continue
            self._tail_len[s] += 1
            self._emit(s, [picked[s]], [logps[s]], events)
        return events

    def _overlap_decode_tick(self, slots: List[int],
                             events: List[RequestOutput]
                             ) -> List[RequestOutput]:
        """Enqueue this tick's decode, then commit the previous one.

        The input panel chains on the device: each slot's token is the
        in-flight tick's sampled token, overridden from the host mirrors
        only where the chain breaks (a slot fresh out of prefill, a slot
        re-admitted since, or a cold pipeline).  The tail mirrors advance
        at dispatch (a decode appends exactly one token), which keeps the
        next refreeze decision exact without waiting."""
        sch = self.scheduler
        b = self.pool.slots
        rec = self._inflight
        mask = [False] * b
        for s in slots:
            mask[s] = True
        chained = set()
        if rec is not None:
            for s, rid in rec["slots"]:
                req = sch.active.get(s)
                if req is not None and req.rid == rid:
                    chained.add(s)
        broken = [s for s in slots if s not in chained]
        if rec is None:
            tokens = torch.zeros((b, 1), dtype=torch.long)
            for s in slots:
                tokens[s, 0] = self._last_tok[s]
        elif broken:
            ov = torch.zeros(b, dtype=torch.long)
            for s in broken:
                ov[s] = self._last_tok[s]
            ovm = sampling.lane_mask(b, broken, self.device)
            tokens = torch.where(ovm, ov.to(self.device, non_blocking=True),
                                 rec["chain"])[:, None]
        else:
            tokens = rec["chain"][:, None]
        logits = self._panel_logits("decode", tokens, mask)
        tok, logp = sampling.sample_step(logits[:, 0], self.lanes,
                                         self._gens, mask,
                                         self._exact_for(mask))
        for s in slots:
            self._tail_len[s] += 1
        # the device token vector chains into the next tick; the host copy
        # is what the commit reads
        new_rec = {**self._to_host(tok=tok, logp=logp, ncommit=None),
                   "chain": tok, "dlen": None,
                   "slots": [(s, sch.active[s].rid) for s in slots]}
        # commit tick t-1 while tick t runs behind it
        self._sync_inflight(events)
        self._inflight = new_rec
        return events

    def _to_host(self, **outs: Optional[torch.Tensor]) -> Dict[str, Any]:
        """Start copying a dispatched tick's outputs to the host right
        behind the work that makes them, before the next tick is enqueued
        (a copy enqueued later would wait for that tick too); the event
        marks their arrival.  On the CPU they are already there."""
        if self.device.type != "cuda":
            return {**outs, "ready": None}
        host = {k: None if v is None else v.to("cpu", non_blocking=True)
                for k, v in outs.items()}
        ready = torch.cuda.Event()
        ready.record()
        return {**host, "ready": ready}

    def _sync_inflight(self, events: List[RequestOutput]) -> None:
        """Commit the in-flight tick's token window: the overlapped
        pipeline's one sync.  Each slot's ``(slot, rid)`` is checked again:
        a request that finished, or whose slot was taken by another, while
        its window was in flight has the window dropped (its appends were
        dead writes, wiped by the release).  No-op when nothing is in
        flight."""
        rec, self._inflight = self._inflight, None
        if rec is None:
            return
        sch = self.scheduler
        if rec["ready"] is not None:
            rec["ready"].synchronize()
        picked, logps = rec["tok"].tolist(), rec["logp"].tolist()
        ncs = rec["ncommit"].tolist() if rec["ncommit"] is not None else None
        for s, rid in rec["slots"]:
            req = sch.active.get(s)
            if req is None or req.rid != rid:
                continue
            if ncs is None:
                self._emit(s, [picked[s]], [logps[s]], events)
                continue
            nc = ncs[s]
            self._tail_len[s] += nc          # t0 + accepted stay appended
            self.spec_hist[nc - 1] += 1      # nc - 1 = accepted drafts
            if self._adaptive is not None:
                self._adaptive.update(s, int(rec["dlen"][s]), nc - 1)
            self._emit(s, picked[s][:nc], logps[s][:nc], events)

    def _verify(self, tokens: torch.Tensor, mask: List[bool],
                dlen: torch.Tensor):
        """Score the ``[slots, k+1]`` panel (appending every position's K/V
        to the live slots' tails), accept per lane, and roll each live
        slot's tail back to ``1 + accepted`` of the appended tokens."""
        qn = tokens.shape[1]
        logits = self._panel_logits("verify", tokens, mask)
        fwd = self._entries["verify"]
        tok, logp, nc = sampling.accept_step(
            logits, fwd.tokens, dlen.to(self.device, non_blocking=True),
            self.lanes, self._gens, mask, self._exact_for(mask))
        self.pool.rollback(self.state, qn * fwd.mask.to(torch.int32) - nc)
        return tok, logp, nc

    def _spec_tick(self, slots: List[int],
                   events: List[RequestOutput]) -> List[RequestOutput]:
        """One draft-verify tick over every decoding slot.

        Each live slot's drafter proposes up to ``k`` continuations of its
        request's history, clamped to the slot's tail headroom (a verify
        appends ``k + 1`` tokens before the accept, and the kept ones must
        fit the ring; a nearly full tail speculates less and the refreeze
        keeps working unchanged) and, when adaptive, to the slot's window.
        One verify scores the panel; each slot then commits its window
        with the stop scan inside it."""
        sch = self.scheduler
        b, k = self.pool.slots, self._spec.k
        tokens = torch.zeros((b, k + 1), dtype=torch.long)
        mask = [False] * b
        dlen = torch.zeros(b, dtype=torch.long)
        for s in slots:
            req = sch.active[s]
            tokens[s, 0] = self._last_tok[s]
            mask[s] = True
            cap = min(k, self.pool.tail - 1 - int(self._tail_len[s]))
            if self._adaptive is not None:
                cap = min(cap, self._adaptive.draft_len(s))
            if cap > 0:
                drafts = self.drafter.propose(req.prompt + req.generated,
                                              cap)
                dlen[s] = len(drafts)
                tokens[s, 1:1 + len(drafts)] = torch.tensor(
                    drafts, dtype=torch.long)
        slot_rids = [(s, sch.active[s].rid) for s in slots]
        tok, logp, ncommit = self._verify(tokens, mask, dlen)
        if self.overlap:
            # dispatched, not synced: the window commits at the next
            # tick's _sync_inflight
            self._inflight = {**self._to_host(tok=tok, logp=logp,
                                              ncommit=ncommit),
                              "dlen": dlen, "slots": slot_rids}
            return events
        picked, logps, ncs = tok.tolist(), logp.tolist(), ncommit.tolist()
        for s in slots:
            if s not in sch.active:
                continue
            nc = ncs[s]
            self._tail_len[s] += nc          # t0 + accepted stay appended
            self.spec_hist[nc - 1] += 1      # nc - 1 = accepted drafts
            if self._adaptive is not None:
                self._adaptive.update(s, int(dlen[s]), nc - 1)
            self._emit(s, picked[s][:nc], logps[s][:nc], events)
        return events

    def _refreeze_tick(self, events: Optional[List[RequestOutput]] = None
                       ) -> None:
        """Refreeze every slot whose tail ring is full (the host mirror
        matches the device-side ``tail_len == tail`` exactly).  The
        refreeze finds the full slots on the device, so it waits for it."""
        full = [s for s in range(self.pool.slots)
                if self._tail_len[s] >= self.pool.tail]
        if not full:
            return
        if self._alloc is not None:
            tb = self.pool.tail // self.pool.bs
            if (self._inflight is not None
                    and len(full) * tb + sum(self._reserved.values())
                    > self._alloc.free_blocks()):
                # a slot whose finishing window is still in flight can show
                # a full tail one tick past its reservation; folding it
                # would take pages promised to other requests.  Drain the
                # pipeline first: the commit releases the finished slots
                self._sync_inflight(events if events is not None else [])
                self._flush_releases()
                full = [s for s in range(self.pool.slots)
                        if self._tail_len[s] >= self.pool.tail]
                if not full:
                    return
            ids = np.zeros((self.pool.slots, tb), np.int64)
            for s in full:
                fresh = self._alloc.alloc(tb)    # CoW: never shared pages
                ids[s] = fresh
                self._blocks.setdefault(s, []).extend(fresh)
                self._reserved[s] = max(0, self._reserved.get(s, 0) - tb)
            self.pool.refreeze(self.state, ids)
        else:
            self.pool.refreeze(self.state)
        for s in full:
            self._tail_len[s] = 0

    def _prefill_tick(self, events: List[RequestOutput]) -> None:
        """One prefill chunk for the oldest request still owed prompt work;
        the final chunk samples (and syncs) the request's first token."""
        sch = self.scheduler
        req = sch.next_prefill()
        if req is None:
            return
        off0 = req.prefill_done
        chunk = sch.prefill_chunk(req)
        final = req.prefill_done >= len(req.prompt)
        toks = torch.tensor([chunk], dtype=torch.long).to(self.device,
                                                          non_blocking=True)
        fresh = None
        if self._alloc is not None:
            nb_new = len(chunk) // self.pool.bs
            fresh = self._alloc.alloc(nb_new) if nb_new else []
        logits, _ = lm.forward_prefill_chunk(self.params, self.state, toks,
                                             req.slot, self.cfg, self.pool.bs,
                                             new_ids=fresh)
        if fresh is not None:
            self._blocks.setdefault(req.slot, []).extend(fresh)
            self._reserved[req.slot] = max(
                0, self._reserved.get(req.slot, 0) - len(fresh))
            # content-address the new blocks only when the chunk ran at
            # full width: block bytes depend on the whole token prefix AND
            # the chunk boundaries, so only full-width-chunk blocks are
            # reproducible by a later prompt prefilled the same way
            if sch.chunk is not None and len(chunk) == sch.chunk:
                hs = block_hashes(req.prompt[:req.prefill_done],
                                  self.pool.bs)
                for i, bid in enumerate(fresh):
                    h = hs[off0 // self.pool.bs + i]
                    if self._alloc.register(bid, h):
                        self._trie.insert(h, bid)
        # device tail_len after a chunk = chunk_len % bs (earlier chunks are
        # block-aligned)
        self._tail_len[req.slot] = req.prefill_done % self.pool.bs
        if final:
            s = req.slot
            lane = {k: v[s:s + 1] for k, v in self.lanes.items()}
            tok, logp = sampling.sample_step(logits, lane, [self._gens[s]],
                                             [True], self._exact[s])
            self._emit(s, [int(tok[0])], [float(logp[0])], events)

    def _emit(self, slot: int, toks: List[int], logprobs: List[float],
              events: List[RequestOutput]) -> None:
        """Commit one tick's token window for a slot (one token, or an
        accepted window under speculation; one snapshot either way);
        recycle the slot if that finished the request."""
        req = self.scheduler.active[slot]
        prefill = not req.generated
        finished = self.scheduler.record_tokens(
            slot, toks, logprobs, decode_tick=not prefill) is not None
        out = req.output()
        events.append(out)
        cb = self._callbacks.get(req.rid)
        if cb is not None:
            cb(out)
        if finished:
            self._callbacks.pop(req.rid, None)
            self._pending_release.append(slot)
            self._tail_len[slot] = 0
            self._last_tok.pop(slot, None)
            if self._adaptive is not None:
                self._adaptive.reset(slot)   # the next tenant starts fresh
        else:
            self._last_tok[slot] = req.generated[-1]
