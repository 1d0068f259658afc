"""Serving engines over the compressed KV cache (twins of
``repro.serving.engine``): the legacy one-shot :class:`Engine` (one static
batch: prefill, freeze, decode lockstep) and the continuous-batching
:class:`ContinuousEngine` (no mesh; the flat pool or, with ``paged=True``,
the shared-prefix paged pool; speculative decoding with
``spec=SpecConfig(k)``; serial or, with ``overlap=True``, overlapped
ticks; the fault-tolerant lifecycle, warm-restart snapshots, the sanitized
pool and the telemetry hooks).

One engine tick (:meth:`step`):

1. **expiry** — every request past its deadline finishes ``"timeout"`` and
   the releases flush, so admission only sees fully released slots;
2. **refreeze** — every slot whose tail ring is full has its tail pruned
   and folded into its compressed prefix, in place;
3. **admission / chunked prefill** — admitted requests get their sampling
   lane; the oldest request owed prompt work gets one chunk prefilled
   against its slot's frozen prefix, and the final chunk samples the
   request's first token;
4. **decode** — every decoding slot advances one token in one batched
   panel forward (``Q == 1``) and the sampler draws each slot's token
   under its own lane.

Host <-> device traffic per tick is one token vector and one chosen-token
logprob vector; slot lengths are mirrored on the host.  Arguments that
belong to a later slice of the port (``ctx``, ``mesh``) raise
``NotImplementedError``.

**Captured entries** (the twin of the reference's ``jax.jit`` entries,
``engine.py:401-481``).  The decode forward (``[slots, 1]``), the verify
forward (``[slots, k+1]``), the prefill chunk (one entry per chunk width
class: the chunk length rounded up to whole blocks, padding behind the
valid tokens), the refreeze, the batched release, the lane write at
admission and, paged, the prefix-hit assignment each run through one
:class:`CapturedEntry` per engine: static inputs (tokens, the slot, the
valid length, fresh page ids, a slot mask, the release vector, the lane's
values or a write flag, all device operands written from pinned host
memory without waiting), one static output, and on CUDA a
``torch.cuda.CUDAGraph`` captured once and replayed, so a tick or a chunk
costs one graph launch instead of thousands of kernel launches.  A chunked
engine captures every entry when it is built (:meth:`ContinuousEngine.warmup`),
so no capture stalls a request; an unchunked one, whose chunk width
classes are power-of-two block counts up to a slot's capacity, captures
each at its first use.  The graphs read the pool's state tensors in place,
and every transition updates those same storages, so no state change
needs a new capture; :meth:`ContinuousEngine.trace_counts` holds it at one
capture per entry (per width class for the chunk).  Nothing but the final
chunk's first token waits for the device on a prefill, a refreeze, a
release or an admission.  The sampler and the verify's accept and
rollback stay eager.  ``graphs=False`` runs the same entries eagerly (the
twin of ``jax.disable_jit()``).

**The engine's stream.**  On CUDA the engine keeps the device and the
stream it was built on, and every public call that touches the device
(:meth:`~ContinuousEngine.step`, :meth:`~ContinuousEngine.cancel`,
:meth:`~ContinuousEngine.quiesce`, :meth:`~ContinuousEngine.warmup`) runs
on them whichever thread makes it, so a server's engine thread replays,
copies and syncs on the stream the graphs were captured and synced
against (a thread's current stream is its own).

**Fault-tolerant lifecycle** (host-side control flow, as in the
reference).  Per-request deadlines (``SamplingParams.deadline_s`` /
``ttft_deadline_s``) enforced at tick start, :meth:`ContinuousEngine.cancel`
for any live request, bounded admission with load shedding
(``max_queue``; a rejected request finishes ``"shed"`` at submit),
exponential-backoff requeue when paged admission cannot reserve pages, and
a degraded mode (``degrade_queue``) that drops the draft window to zero
under queue pressure, through the same ``[slots, k+1]`` verify graph.
``fault_counters`` tallies every abnormal event; a double release is
counted against the ``_slot_live`` mirror, skips the allocator and still
reaches the device, where it is a masked no-op.  A seeded
:class:`~.faults.FaultPlan` (``faults=``) fires failures at the five
engine sites.  An optional :class:`repro_torch.obs.Observability`
(``obs=``) is fed host values only: no hook reads a device tensor.

**Overlapped ticks** (``overlap=True``, the twin of the reference's
``_overlap_decode_tick`` / ``_sync_inflight``).  Tick t+1's decode is
enqueued before tick t's tokens reach the host: its input is tick t's
token vector on the device, overridden from the host only where the chain
breaks.  Under speculation the pipeline is shallow: the verify enqueued
last tick commits after this tick's prefill dispatch and before its
refreeze and drafting.  :meth:`ContinuousEngine._sync_inflight` is the one
place a tick's tokens reach the host; it re-checks ``(slot, rid)``, so a
window dispatched for a request that finished, was cancelled or expired
meanwhile is dropped.  :meth:`ContinuousEngine.quiesce` drains the
pipeline.

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
:meth:`ContinuousEngine.save_snapshot` / :meth:`ContinuousEngine.load_snapshot`
persist the arena and the prefix index through
:class:`repro_torch.checkpoint.CheckpointManager` for a warm restart; the
load copies into the live arena tensors, so no entry is captured again.

**Sanitized mode** (``checkify=True`` or ``REPRO_CHECKIFY=1``).  The pool's
checks OR bits into a device error word (``serving/cache_pool.py``) inside
the captured entries; the engine reads the word in the same device-to-host
copy as a tick's tokens and raises :class:`~.cache_pool.PoolCheckError`
there, naming every failed check.  Chunks, refreezes and assignments stay
free of host syncs: their bits surface at the next token read.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import kernels, resolve_device
from repro_torch.core.sparse_format import repack_capacity
from repro_torch.core.sparse_kv import SparseKVCache, freeze_prefix, refreeze
from repro_torch.models import lm
from repro_torch.models.attention import DenseKVCache
from . import sampling
from .cache_pool import BlockAllocator, CachePool, check_errors
from .cache_pool import tensors as _leaves
from .faults import (CANCEL_PREFILL, CANCEL_SPEC, DOUBLE_RELEASE,
                     DRAFTER_ERROR, PAGE_EXHAUSTION, FaultPlan)
from .sampling import RequestOutput, SamplingParams
from .scheduler import PrefixTrie, Scheduler, block_hashes
from .spec import AdaptiveDraft, SpecConfig


def params_to(tree: Any, device: torch.device) -> Any:
    """Move a params tree (tensors and sparse weights) to ``device``.  On
    CUDA a dense layer-stacked linear weight ``[L, K, N]`` is also stored
    column-major (the same values), so that the dense kernel reads each
    layer's weight as ``[N, K]`` rows in place, as it reads the tied
    embedding."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    out = tree.to(device)
    if torch.is_tensor(out) and out.dim() == 3 and out.is_cuda:
        out = out.transpose(1, 2).contiguous().transpose(1, 2)
    return out


class Engine:
    """The legacy one-shot engine: one static batch, prefilled whole,
    frozen into a :class:`~repro_torch.core.sparse_kv.SparseKVCache` (or a
    :class:`~repro_torch.models.attention.DenseKVCache` with
    ``kv_mode="dense"``) and decoded lockstep; the numerical baseline of
    the continuous engine.  Runs on the CUDA device unless
    ``device="cpu"``, through the same kernels: the gemv (decode linears,
    ``M = B``), the sparse matmul (the prefill's linears at ``M = B * S``),
    the fused attention over the sparse cache, and the unembedding.

    It runs **eagerly**: every refreeze grows the prefix (a new shape), so
    the reference retraces its jitted decode at each one, and a CUDA graph
    would have to be captured again just as often."""

    def __init__(self, params, cfg, kv_mode: str = "sparse",
                 device: Optional[torch.device] = None):
        if kv_mode not in ("sparse", "dense"):
            raise ValueError(f"unknown kv_mode {kv_mode!r}")
        lm._attn_kinds(cfg)
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.cfg = cfg
        self.kv_mode = kv_mode
        self._tail = 0            # host mirror of every layer's tail_len

    def prefill(self, batch: Dict[str, Any]):
        """Prefill ``batch["tokens"] [B, S]`` (host or device); returns
        ``(cache, logits [B, V] f32 of the last prompt token)``."""
        cfg = self.cfg
        tokens = batch["tokens"]
        if not torch.is_tensor(tokens):
            tokens = torch.as_tensor(np.asarray(tokens))
        tokens = tokens.to(self.device, torch.long)
        hidden, collected = lm.forward_prefill(self.params,
                                               {"tokens": tokens}, cfg)
        layers = {name: {"kv": self._build_kv(got["k"], got["v"])}
                  for name, got in collected["layers"].items()}
        cache = {"pos": torch.tensor(collected["len"], dtype=torch.int32,
                                     device=self.device),
                 "layers": layers}
        self._tail = 0
        logits = lm.logits_fn(self.params, hidden[:, -1:], cfg)
        return cache, logits[:, 0]

    def _build_kv(self, k_stack: torch.Tensor, v_stack: torch.Tensor):
        """``k/v [P, B, Hkv, S, hd]`` -> the per-period caches, stacked.
        Sparse: a first pass finds the largest capacity any period's data
        needs, a second packs every period at it, so the stack is
        rectangular (the paper's fixed offline capacity)."""
        cfg = self.cfg
        n_periods, s = k_stack.shape[0], k_stack.shape[3]
        if self.kv_mode == "dense":
            pad = lambda a: F.pad(a, (0, 0, 0, cfg.kv_tail))
            return DenseKVCache(pad(k_stack), pad(v_stack), torch.full(
                (n_periods,), s, dtype=torch.int32, device=self.device))
        bs = min(128, s)
        cap_k = cap_v = None
        if n_periods > 1:
            probes = [freeze_prefix(k_stack[i], v_stack[i],
                                    cfg.kv_k_sparsity, cfg.kv_v_sparsity,
                                    tail_size=cfg.kv_tail, bs=bs)
                      for i in range(n_periods)]
            cap_k = max(p.k_sp.capacity for p in probes)
            cap_v = max(p.v_sp.capacity for p in probes)
        return SparseKVCache.stack([
            freeze_prefix(k_stack[i], v_stack[i], cfg.kv_k_sparsity,
                          cfg.kv_v_sparsity, tail_size=cfg.kv_tail, bs=bs,
                          capacity_k=cap_k, capacity_v=cap_v)
            for i in range(n_periods)])

    def generate(self, batch: Dict[str, Any],
                 params: Optional[SamplingParams] = None):
        """Decode ``params.max_new_tokens`` tokens for the whole batch under
        one shared ``params`` (eos and stop sequences are refused: a static
        batch decodes a fixed length; the continuous engine handles them).
        Returns ``([B, max_new_tokens] int32 tokens on the device, final
        cache)``; the first token is sampled from the prompt's last
        logits."""
        params = params if params is not None else SamplingParams()
        if params.eos_id is not None or params.stop_ids:
            raise ValueError(
                "the one-shot Engine decodes fixed-length lockstep batches "
                "and cannot honor eos_id/stop_ids; submit to "
                "ContinuousEngine for per-request stop handling")
        if self.kv_mode == "dense" and \
                params.max_new_tokens - 1 > self.cfg.kv_tail:
            raise ValueError(
                f"the dense cache holds the prompt + kv_tail "
                f"({self.cfg.kv_tail}) tokens: {params.max_new_tokens} new "
                f"tokens decode {params.max_new_tokens - 1} past the prompt")
        cache, logits = self.prefill(batch)
        b = logits.shape[0]
        lanes = sampling.broadcast_lanes(params, b, self.device)
        gens = [sampling.request_generator(params, self.device)
                if params.temperature > 0 else None for _ in range(b)]
        live = [True] * b
        exact = sampling.needs_exact_sort(params, self.cfg.vocab)
        tok, _ = sampling.sample_step(logits, lanes, gens, live, exact)
        toks = []
        for _ in range(params.max_new_tokens - 1):
            toks.append(tok)
            if self.kv_mode == "sparse":
                cache = self._maybe_refreeze(cache)
            logits, cache = lm.forward_decode(self.params, cache,
                                              tok[:, None], self.cfg)
            self._tail += 1
            tok, _ = sampling.sample_step(logits, lanes, gens, live, exact)
        toks.append(tok)
        return torch.stack(toks, dim=1).to(torch.int32), cache

    def _maybe_refreeze(self, cache):
        """Fold full tails back into the compressed prefix (paper §6.2's
        amortised step), between decode steps.  The tails fill in lockstep,
        so the host mirror of ``tail_len`` decides without reading the
        device; the prefix grows, so the caches are rebuilt (re-packed at
        a common capacity when the periods' differ)."""
        cfg = self.cfg
        changed = False
        layers = dict(cache["layers"])
        for name, leaf in layers.items():
            kv = leaf["kv"]
            if self._tail < kv.k_tail.shape[3]:
                continue
            per = [refreeze(kv.layer(i), cfg.kv_k_sparsity,
                            cfg.kv_v_sparsity)
                   for i in range(kv.k_tail.shape[0])]
            cap_k = max(p.k_sp.capacity for p in per)
            cap_v = max(p.v_sp.capacity for p in per)
            if any(p.k_sp.capacity != cap_k or p.v_sp.capacity != cap_v
                   for p in per):
                per = [self._repack(p, cap_k, cap_v) for p in per]
            layers[name] = {**leaf, "kv": SparseKVCache.stack(per)}
            changed = True
        if not changed:
            return cache
        self._tail = 0
        return {**cache, "layers": layers}

    def _repack(self, kvc: SparseKVCache, cap_k: int, cap_v: int
                ) -> SparseKVCache:
        """One period's cache at the stack-wide capacity
        (:func:`~repro_torch.core.sparse_format.repack_capacity` keeps the
        bitmap and the values consistent either way)."""
        return SparseKVCache(repack_capacity(kvc.k_sp, cap_k),
                             repack_capacity(kvc.v_sp, cap_v),
                             kvc.k_tail, kvc.v_tail, kvc.tail_len)


def stable_trace_counts(counts: Dict[str, int],
                        ignore: tuple = ("prefill_chunk",)) -> Dict[str, int]:
    """The entries of :meth:`ContinuousEngine.trace_counts` that must stay
    flat after warm-up (twin of the reference's ``stable_trace_counts``):
    ``prefill_chunk`` legitimately takes one capture per chunk width class
    it meets, so it is left out."""
    return {k: v for k, v in counts.items() if k not in ignore}


def _entry_name(key) -> str:
    """An entry's name from its key (``(name, width)`` for prefill)."""
    return key if isinstance(key, str) else key[0]


def _counted(fn: Callable[[], Any]):
    """Run ``fn``; returns its output and the launches each kernel wrapper
    counted meanwhile, with every counter put back as it was."""
    before = kernels.launch_counts()
    out = fn()
    after = kernels.launch_counts()
    kernels.set_launch_counts(before)
    return out, {k: n - before[k] for k, n in after.items()
                 if n != before[k]}


def _stage(dst: torch.Tensor, value) -> None:
    """Write ``value`` (host values, a host tensor or a device tensor of
    ``dst``'s shape) into the static input ``dst`` without waiting for the
    device: host data goes through pinned memory, whose block the caching
    host allocator keeps until the copy has run."""
    if not torch.is_tensor(value):
        value = torch.as_tensor(np.asarray(value)).to(dst.dtype)
    if dst.is_cuda and not value.is_cuda:
        value = value.pin_memory()
    dst.copy_(value, non_blocking=True)


class CapturedEntry:
    """One engine entry over the pool: the port's counterpart of a jitted
    entry compiled once.

    ``inputs`` are static tensors that ``fn`` reads (and :meth:`set`
    writes in place); ``fn`` returns the static output (or None) and
    reads ``params`` and the pool ``state`` where they lie, updating the
    state in place.  On CUDA ``fn`` is captured once as a
    ``torch.cuda.CUDAGraph`` (in its own memory pool) after one eager
    warm-up on a side stream, so that every kernel's first launch, the
    kernels' per-device scratch and the plans are made outside the
    capture; the caller's initial inputs must make ``fn`` write nothing
    (an all-false mask, a false write flag).  Each :meth:`run` replays the
    graph and adds the kernel launches it holds to the wrappers' counters.
    On the CPU the capture and each replay call ``fn`` on the static
    inputs and copy its output into the same tensor, with the same warm-up
    and launch accounting.  ``eager=True`` calls ``fn`` each run and
    returns a fresh output (no capture).  ``capture_s`` is the host time
    of the warm-up and capture, ``graph_bytes`` the memory the graph's
    pool reserved.

    A replay after a state tensor was replaced by another raises: the
    graph would read storage that is no longer the pool's."""

    def __init__(self, state: Dict[str, Any], inputs: Dict[str, torch.Tensor],
                 fn: Callable[[], Optional[torch.Tensor]],
                 eager: bool = False):
        self.inputs = inputs
        self._state, self._leaves = state, _leaves(state)
        self._fn = fn
        self.eager = eager
        self.captures = self.replays = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.held: Dict[str, int] = {}      # kernel launches one run holds
        self.capture_s, self.graph_bytes = 0.0, 0
        self._staged: Dict[str, bytes] = {}  # last host value per input
        if not eager:
            self._capture()

    def _capture(self) -> None:
        t0 = time.perf_counter()
        dev = self._leaves[0].device
        if dev.type == "cuda":
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._fn()
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                before = torch.cuda.memory_reserved(dev)
                self.out, self.held = _counted(self._fn)
            self.graph_bytes = torch.cuda.memory_reserved(dev) - before
        else:
            self._fn()
            self.out, self.held = _counted(self._fn)
        self.capture_s = time.perf_counter() - t0
        self.captures += 1

    def set(self, **values) -> None:
        """Write the named static inputs without waiting for the device.  A
        host value (a list or an array) equal to the last one written to
        the same input is not copied again."""
        for name, v in values.items():
            key = None if torch.is_tensor(v) else np.asarray(v).tobytes()
            if key is None or self._staged.get(name) != key:
                _stage(self.inputs[name], v)
            self._staged[name] = key

    def run(self) -> Optional[torch.Tensor]:
        """``fn`` on the current inputs; returns the static output, which
        the next run overwrites (in eager mode, a fresh output)."""
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
            if self.out is not None:
                self.out.copy_(out)
        for name, n in self.held.items():
            kernels.KERNELS[name].launches += n
        return self.out


def panel_entry(params, state: Dict[str, Any], cfg, bs: int, qn: int,
                eager: bool = False) -> CapturedEntry:
    """One panel forward over the pool at a fixed width ``Q`` (the decode
    entry at ``Q = 1``, the verify entry at ``k + 1``): static inputs
    ``tokens`` (int64 ``[B, Q]``) and ``mask`` (bool ``[B]``, all false at
    the warm-up and capture, which then write nothing); the output is the
    logits (f32 ``[B, Q, V]``)."""
    dev = state["pos"].device
    b = state["pos"].shape[0]
    inp = {"tokens": torch.zeros((b, qn), dtype=torch.long, device=dev),
           "mask": torch.zeros(b, dtype=torch.bool, device=dev)}
    return CapturedEntry(state, inp, lambda: lm.forward_panel_pooled(
        params, state, inp["tokens"], inp["mask"], cfg, bs)[0], eager)


def _writing_entry(state: Dict[str, Any], inputs: Dict[str, torch.Tensor],
                   fn: Callable[[], Optional[torch.Tensor]],
                   eager: bool) -> CapturedEntry:
    """An entry whose ``fn`` writes ``state`` under a ``write`` flag (bool
    ``[1]``): false for the warm-up and capture, true once captured."""
    inputs["write"] = torch.zeros(1, dtype=torch.bool,
                                  device=_leaves(state)[0].device)
    fwd = CapturedEntry(state, inputs, fn, eager=eager)
    fwd.set(write=[True])
    return fwd


def prefill_entry(params, state: Dict[str, Any], cfg, bs: int, w: int,
                  eager: bool = False) -> CapturedEntry:
    """The prefill chunk at width class ``w`` (a multiple of ``bs``):
    static inputs ``tokens`` (int64 ``[1, w]``, valid tokens first),
    ``slot`` and ``length`` (int64 ``[1]``), ``write`` and, on the paged
    pool, ``ids`` (the fresh pages, int64 ``[w // bs]``); the output is
    the last valid token's logits (f32 ``[1, V]``)."""
    dev = state["pos"].device
    inp = {"tokens": torch.zeros((1, w), dtype=torch.long, device=dev),
           "slot": torch.zeros(1, dtype=torch.long, device=dev),
           "length": torch.full((1,), w, dtype=torch.long, device=dev)}
    if "table" in state:
        inp["ids"] = torch.zeros(w // bs, dtype=torch.long, device=dev)
    return _writing_entry(state, inp, lambda: lm.forward_prefill_chunk(
        params, state, inp["tokens"], inp["slot"], cfg, bs,
        new_ids=inp.get("ids"), length=inp["length"],
        write=inp["write"])[0], eager)


def refreeze_entry(pool: CachePool, state: Dict[str, Any],
                   eager: bool = False) -> CapturedEntry:
    """The refreeze: static inputs ``write`` and, on the paged pool, ``ids``
    (the fresh pages, int64 ``[slots, tail // bs]``, rows of slots that are
    not full ignored); no output."""
    inp = {}
    if pool.paged:
        inp["ids"] = torch.zeros((pool.slots, pool.tail // pool.bs),
                                 dtype=torch.long, device=pool.device)

    def fn():
        pool.refreeze(state, inp.get("ids"), inp["write"])
    return _writing_entry(state, inp, fn, eager)


def assign_entry(pool: CachePool, state: Dict[str, Any],
                 eager: bool = False) -> CapturedEntry:
    """The prefix-hit assignment (paged pool): static inputs ``slot`` and
    ``n`` (int64 ``[1]``), ``ids`` (the shared pages, int64
    ``[max_blocks]``) and ``write``; no output."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.long,
                                   device=pool.device)
    inp = {"slot": z(1), "ids": z(pool.max_blocks), "n": z(1)}

    def fn():
        pool.assign_blocks(state, inp["slot"], inp["ids"], inp["n"],
                           inp["write"])
    return _writing_entry(state, inp, fn, eager)


def release_entry(pool: CachePool, state: Dict[str, Any],
                  eager: bool = False) -> CapturedEntry:
    """The batched release: static input ``slots`` (int32 ``[slots]``, the
    slots to recycle first, ``-1`` where nothing is released, as the
    reference's ``_flush_releases`` pads it); no output.  The all ``-1``
    vector of the warm-up and capture releases nothing, and releasing a
    free slot is a masked no-op, so no write flag is needed."""
    inp = {"slots": torch.full((pool.slots,), -1, dtype=torch.int32,
                               device=pool.device)}

    def fn():
        pool.release(state, inp["slots"])
    return CapturedEntry(state, inp, fn, eager=eager)


def set_lane_entry(lanes: Dict[str, torch.Tensor],
                   eager: bool = False) -> CapturedEntry:
    """One slot's sampling lane written at admission
    (:func:`~.sampling.set_lane`): static inputs ``slot`` (int64 ``[1]``),
    ``temperature``, ``top_k``, ``top_p`` (``[1]`` in their lane's dtype)
    and ``write``; no output."""
    dev = lanes["temperature"].device
    inp = {"slot": torch.zeros(1, dtype=torch.long, device=dev),
           **{k: torch.zeros(1, dtype=v.dtype, device=dev)
              for k, v in lanes.items()}}

    def fn():
        sampling.set_lane(lanes, inp["slot"], inp["temperature"],
                          inp["top_k"], inp["top_p"], inp["write"])
    return _writing_entry(lanes, inp, fn, eager)


def _on_device(method):
    """Run an engine method on the engine's CUDA device and stream,
    whichever thread calls it (a no-op on the CPU)."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with self._on_stream():
            return method(self, *args, **kwargs)
    return run


class ContinuousEngine:
    """Continuous-batching engine: requests stream through a
    :class:`CachePool` of fixed-geometry slots under a :class:`Scheduler`;
    chunked prefill interleaves with decode ticks and slots recycle on
    completion, cancellation or expiry.  Runs on the CUDA device unless
    ``device="cpu"``.

    ``overlap=True`` enqueues each tick before the previous tick's tokens
    reach the host; greedy and seeded output are identical either way.
    ``graphs=False`` runs every entry eagerly instead of through its
    captured :class:`CapturedEntry` (tests and oracles only).
    ``max_queue``, ``degrade_queue``, ``faults``, ``obs``,
    ``capacity_slack`` and ``checkify`` mean what they mean in the
    reference."""

    def __init__(self, params, cfg, slots: int = 4, max_tokens: int = 0,
                 bs: int = 0, prefill_chunk: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 device: Optional[torch.device] = None, *,
                 ctx=None, spec=None, mesh=None, paged: bool = False,
                 phys_blocks: int = 0, checkify: Optional[bool] = None,
                 capacity_slack: float = 1.25, max_queue: int = 0,
                 degrade_queue: int = 0, faults: Optional[FaultPlan] = None,
                 obs=None, overlap: bool = False, graphs: bool = True):
        later = {"ctx": ctx is not None, "mesh": mesh is not None}
        unported = [k for k, v in later.items() if v]
        if unported:
            raise NotImplementedError(
                f"ContinuousEngine options {unported} belong to the sharded "
                "slice of the port")
        self.device = resolve_device(device)
        # the device and stream every device call of this engine runs on,
        # whichever thread makes it (:meth:`_on_stream`)
        self.stream: Optional[torch.cuda.Stream] = None
        if self.device.type == "cuda":
            index = (self.device.index if self.device.index is not None
                     else torch.cuda.current_device())
            self._cuda = torch.device("cuda", index)
            self.stream = torch.cuda.current_stream(self._cuda)
        self.cfg = cfg
        max_tokens = max_tokens or 4 * cfg.kv_tail
        if not bs:
            # largest tail divisor <= min(128, prefill_chunk): chunks stay
            # block-aligned and the tail folds in whole blocks
            limit = min(128, prefill_chunk or 128, cfg.kv_tail)
            bs = next(d for d in range(limit, 0, -1)
                      if cfg.kv_tail % d == 0)
        self.pool = CachePool.build(cfg, slots, max_tokens, bs=bs,
                                    capacity_slack=capacity_slack,
                                    device=self.device, paged=paged,
                                    n_phys=phys_blocks, checkify=checkify)
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
                                   max_queue=max_queue, **sch_kw)
        # host mirrors (avoid a device sync per tick)
        self._tail_len = np.zeros(slots, np.int64)
        self._last_tok: Dict[int, int] = {}
        self._callbacks: Dict[int, Callable[[RequestOutput], None]] = {}
        self._pending_release: List[int] = []         # flushed once per tick
        # fault-tolerant lifecycle: the seeded fault plan (None in
        # production), the degraded-mode queue threshold, and which slots
        # hold admitted device state (a double release is detected against
        # it on the host and counted, never acted on twice)
        self._faults = faults
        self._degrade_queue = degrade_queue
        self._tick_no = 0
        self._in_tick = False
        self._slot_live = np.zeros(slots, bool)
        self.fault_counters: Dict[str, int] = {
            "shed": 0, "timeout": 0, "cancelled": 0, "double_release": 0,
            "drafter_error": 0, "deferred": 0, "degraded_ticks": 0,
            "injected_page_exhaustion": 0}
        # observability (repro_torch.obs.Observability or None): fed plain
        # host values at the tick boundary, the token read and the host
        # submit and cancel paths, never a device tensor
        self._obs = obs
        self._tick_committed = 0          # tokens committed this tick
        if obs is not None and faults is not None:
            faults.on_fire = (
                lambda site, tick: obs.fault(site, tick,
                                             self.scheduler.clock()))
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
        # the captured entries, keyed by name (the chunk: by name and
        # width class): all of them now on a chunked engine, else at first
        # use
        self._graphs = bool(graphs)
        self._entries: Dict[Any, CapturedEntry] = {}
        # the overlapped pipeline: the dispatched, not yet committed tick
        self.overlap = bool(overlap)
        self._inflight: Optional[Dict[str, Any]] = None
        if self.scheduler.chunk is not None:
            self.warmup()

    def _on_stream(self):
        """The engine's CUDA device and stream as the current ones (a
        thread's current stream is its own: a server's engine thread would
        otherwise run on the default stream, not the one the graphs were
        captured and synced against)."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self._cuda))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    # -- public API ---------------------------------------------------------
    def submit(self, prompt, params: Optional[SamplingParams] = None,
               on_token: Optional[Callable[[RequestOutput], None]] = None
               ) -> int:
        """Queue a request under its own :class:`SamplingParams`; returns
        the request id.  ``on_token`` gets a snapshot per committed token
        window.

        Under load shedding (``max_queue`` set, queue full) the request is
        rejected at once: ``on_token`` fires exactly once with a final
        ``finish_reason="shed"`` snapshot and nothing is registered."""
        toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
        rid = self.scheduler.submit(toks, params)
        if self._obs is not None:
            # the post-submit depth: a shed never entered the queue
            self._obs.request_submitted(rid, len(toks),
                                        self.scheduler.clock(),
                                        queue_depth=len(self.scheduler.queue))
        req = self.scheduler.finished.get(rid)
        if req is not None and req.finish_reason == "shed":
            # one counter path: the scheduler sheds and counts, the engine
            # mirror re-syncs from it
            self.fault_counters["shed"] = self.scheduler.shed_count
            out = req.output()
            if self._obs is not None:
                self._obs.request_finished(out, self.scheduler.clock())
            if on_token is not None:
                on_token(out)
            return rid
        if on_token is not None:
            self._callbacks[rid] = on_token
        return rid

    @_on_device
    def cancel(self, rid: int) -> bool:
        """Cancel a request wherever it lives (queued, prefilling or
        decoding).  Returns whether anything was cancelled: a request that
        already finished (or was never submitted) is a quiet ``False``.  An
        active request's slot goes through the batched release (at once
        between ticks); its ``on_token`` gets one final
        ``finish_reason="cancelled"`` snapshot."""
        return self._cancel_inner(rid) is not None

    def _cancel_inner(self, rid: int) -> Optional[RequestOutput]:
        req = self.scheduler.cancel(rid)
        if req is None:
            return None
        self.fault_counters["cancelled"] += 1
        if req.slot >= 0:
            self._abort_slot(req.slot)
        out = req.output()
        if self._obs is not None:
            self._obs.request_finished(out, self.scheduler.clock())
        cb = self._callbacks.pop(rid, None)
        if cb is not None:
            cb(out)
        return out

    def _abort_slot(self, slot: int) -> None:
        """Tear down an active slot outside the normal finish (cancel or
        expiry): queue its release and reset the host mirrors.  Outside a
        tick the release flushes at once, so a cancel between ticks leaves
        no page pinned."""
        self._pending_release.append(slot)
        self._tail_len[slot] = 0
        self._last_tok.pop(slot, None)
        if self._adaptive is not None:
            self._adaptive.reset(slot)
        if not self._in_tick:
            self._flush_releases()

    def _expire_deadlines(self, now: float,
                          events: List[RequestOutput]) -> None:
        """Finish every request past its deadline (``"timeout"``),
        releasing the slots of active ones.  Runs at tick start, before
        this tick's decode, so a stop committed last tick has already won:
        a deadline never retracts emitted output."""
        for req in self.scheduler.expire(now):
            self.fault_counters["timeout"] += 1
            if req.slot >= 0:
                self._abort_slot(req.slot)
            out = req.output()
            if self._obs is not None:
                self._obs.request_finished(out, now)
            events.append(out)
            cb = self._callbacks.pop(req.rid, None)
            if cb is not None:
                cb(out)

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

    @_on_device
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
        """Captures per entry (twin of the reference's jit trace counts,
        under its key names): ``decode``; ``prefill_chunk``, one per chunk
        width class (``chunk // bs`` on a chunked engine); ``refreeze``;
        ``release``; ``set_lane``; ``assign`` on the paged pool; ``verify``
        under speculation.  Each but ``prefill_chunk`` is 1 once captured
        (a chunked engine captures every entry when it is built), whatever
        refreezes, admissions, cancellations and releases came between; 0
        for an entry not captured yet and under ``graphs=False``."""
        names = ["decode", "prefill_chunk", "refreeze", "release",
                 "set_lane"]
        names += ["assign"] if self._alloc is not None else []
        names += ["verify"] if self._spec is not None else []
        counts = dict.fromkeys(names, 0)
        for key, e in self._entries.items():
            counts[_entry_name(key)] += e.captures
        return counts

    def replay_counts(self) -> Dict[str, int]:
        """Runs per entry name (graph replays, or eager runs under
        ``graphs=False``), for the entries made so far."""
        counts: Dict[str, int] = {}
        for key, e in self._entries.items():
            name = _entry_name(key)
            counts[name] = counts.get(name, 0) + e.replays
        return counts

    @_on_device
    def warmup(self) -> None:
        """Capture every entry this engine's ticks can run: the decode
        forward (under speculation, the verify forward), the prefill chunk
        at each width class (:meth:`_width`), the refreeze, the release,
        the lane write and, paged, the assignment.  The constructor calls
        it for a chunked engine, so no capture stalls a request; an
        unchunked engine captures each class at its first use unless this
        is called.  A no-op under ``graphs=False``."""
        if not self._graphs:
            return
        self._entry("verify" if self._spec is not None else "decode")
        for w in sorted({self._width(n) for n in range(
                1, (self.scheduler.chunk or self.pool.capacity_tokens) + 1,
                self.pool.bs)}):
            self._entry("prefill_chunk", w)
        for name in ("refreeze", "release", "set_lane"):
            self._entry(name)
        if self._alloc is not None:
            self._entry("assign")

    def _width(self, n: int) -> int:
        """The width class of an ``n``-token chunk: ``n`` rounded up to
        whole blocks; on an unchunked engine, up to a power-of-two count of
        blocks (at most the slot's), so its classes number about log2 of
        the capacity in blocks and their graphs' memory stays below twice
        the largest's."""
        bs = self.pool.bs
        blocks = -(-n // bs)
        if self.scheduler.chunk is None:
            blocks = min(1 << (blocks - 1).bit_length(), self.pool.max_blocks)
        return blocks * bs

    def _entry(self, name: str, width: int = 0) -> CapturedEntry:
        """The entry ``name`` (``decode``: ``[slots, 1]``; ``verify``:
        ``[slots, k+1]``; ``prefill_chunk`` at the chunk width class
        ``width``; ``refreeze``; ``release``; ``set_lane``; ``assign``),
        captured at its first use unless :meth:`warmup` captured it."""
        key = (name, width) if name == "prefill_chunk" else name
        fwd = self._entries.get(key)
        if fwd is not None:
            return fwd
        eager = not self._graphs
        if name in ("decode", "verify"):
            qn = 1 if name == "decode" else self._spec.k + 1
            fwd = panel_entry(self.params, self.state, self.cfg,
                              self.pool.bs, qn, eager=eager)
        elif name == "prefill_chunk":
            fwd = prefill_entry(self.params, self.state, self.cfg,
                                self.pool.bs, width, eager=eager)
        elif name == "set_lane":
            fwd = set_lane_entry(self.lanes, eager=eager)
        else:
            make = {"refreeze": refreeze_entry, "release": release_entry,
                    "assign": assign_entry}[name]
            fwd = make(self.pool, self.state, eager=eager)
        self._entries[key] = fwd
        return fwd

    def _panel_logits(self, name: str, tokens: torch.Tensor,
                      mask: Sequence[bool]) -> torch.Tensor:
        """One ``[slots, Q]`` panel forward through entry ``name`` on
        ``tokens`` (host or device) and the slot mask; every live slot's
        ``Q`` tokens are appended to its tail.  Returns the logits (the
        entry's static output: read them before the entry runs again)."""
        fwd = self._entry(name)
        fwd.set(tokens=tokens, mask=[bool(m) for m in mask])
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

    # -- crash-safe warm restart --------------------------------------------
    def _snapshot_guard(self, what: str) -> None:
        if self._alloc is None:
            raise ValueError(f"{what} needs the paged pool: only the shared "
                             "arena + prefix index persist (build the "
                             "engine with paged=True)")

    @_on_device
    def save_snapshot(self, directory: str) -> int:
        """Persist the warm-restart state of the paged pool under
        ``directory`` (written to a temporary directory and renamed into
        place by :class:`~repro_torch.checkpoint.CheckpointManager`): the
        arena leaves, the chained-hash -> page pairs of the prefix index
        and the allocator's registered population.  In-flight request state
        (tails, tables, lengths) is not saved: after a crash only the
        shareable frozen content survives.  Drains the overlapped pipeline
        first, so no dispatched tick writes the arena while it is copied.
        Returns the step written."""
        self._snapshot_guard("save_snapshot")
        self.quiesce()
        from repro_torch.checkpoint import CheckpointManager
        t0 = self.scheduler.clock() if self._obs is not None else 0.0
        pairs = self._alloc.export_registered()
        tree = {"arena": self.pool.arena_leaves(self.state),
                "hashes": np.asarray([h for h, _ in pairs], np.int64),
                "ids": np.asarray([b for _, b in pairs], np.int32)}
        mgr = CheckpointManager(directory, keep=2)
        step = (mgr.latest_step() or 0) + 1
        mgr.save(step, tree,
                 meta={"kind": "serving-prefix-cache",
                       "geometry": self.pool.geometry(),
                       "n_registered": len(pairs)},
                 blocking=True)
        if self._obs is not None:
            self._obs.snapshot_event("save", t0,
                                     self.scheduler.clock() - t0,
                                     len(pairs))
        return step

    @_on_device
    def load_snapshot(self, directory: str) -> int:
        """Warm-restart from the newest snapshot under ``directory`` (the
        port's or the reference's: the files are the same): copy the arena
        leaves into the live arena tensors, and rebuild the prefix trie and
        the allocator's cached population (every restored page at refcount
        0, revivable by a prefix hit, evictable from the cold end in
        snapshot order).  A later prompt whose prefix was frozen before the
        crash skips its prefill.  No captured entry is made again: the
        arena tensors keep their storage.

        Idle engines only, and the device refcounts and tables of an idle
        engine must be all zero (checked, not assumed).  A snapshot of
        another geometry raises a ``ValueError`` naming every mismatched
        field; a corrupt one raises a readable ``ValueError``; neither
        changes anything.  Returns the number of restored pages."""
        self._snapshot_guard("load_snapshot")
        self.quiesce()
        t0 = self.scheduler.clock() if self._obs is not None else 0.0
        if self.scheduler.active or self.scheduler.queue or self._blocks:
            raise ValueError("load_snapshot on a busy engine: restore "
                             "before submitting traffic")
        if self.state["refcount"].any() or self.state["table"].any():
            raise RuntimeError("load_snapshot: an idle engine's device "
                               "refcounts and block tables must be zero")
        from repro_torch.checkpoint import CheckpointManager
        mgr = CheckpointManager(directory, keep=2)
        step = mgr.latest_step()
        if step is None:
            raise ValueError(f"no snapshot under {directory!r}")
        manifest = mgr.read_manifest(step)
        if manifest.get("kind") != "serving-prefix-cache":
            raise ValueError(
                f"snapshot step {step} under {directory!r} is not a serving "
                f"prefix cache (kind={manifest.get('kind')!r})")
        mine, theirs = self.pool.geometry(), manifest.get("geometry") or {}
        bad = [f"{k}: engine has {mine[k]!r}, snapshot has "
               f"{theirs.get(k)!r}" for k in mine if theirs.get(k) != mine[k]]
        if bad:
            raise ValueError("snapshot geometry mismatch — " + "; ".join(bad))
        n = int(manifest["n_registered"])
        # the template has the live arena's shapes and dtypes and allocates
        # nothing (a second arena on the card would double its memory)
        like = {"arena": {name: {k: torch.empty(t.shape, dtype=t.dtype,
                                                device="meta")
                                 for k, t in leaves.items()}
                          for name, leaves in
                          self.pool.arena_leaves(self.state).items()},
                "hashes": np.zeros(n, np.int64),
                "ids": np.zeros(n, np.int32)}
        tree, _ = mgr.restore(step, like, to_device=False)
        pairs = list(zip((int(h) for h in tree["hashes"]),
                         (int(b) for b in tree["ids"])))
        self._alloc.validate_registered(pairs)
        self.pool.load_arena(self.state, tree["arena"])
        self._alloc.restore_registered(pairs)
        self._trie.reload(pairs)
        if self._obs is not None:
            self._obs.snapshot_event("load", t0,
                                     self.scheduler.clock() - t0,
                                     len(pairs))
        return len(pairs)

    # -- one tick -----------------------------------------------------------
    @_on_device
    def step(self) -> List[RequestOutput]:
        """Advance one tick; returns a snapshot per token emitted.  Slots
        freed this tick are released together at its end, in one replay
        of the ``release`` entry.

        Deadline expiry and the release flush run first, so a slot freed
        by a timeout (or by a cancel between ticks) is fully released
        before any request can be admitted into it."""
        obs = self._obs
        t_start = self.scheduler.clock() if obs is not None else 0.0
        self._tick_no += 1
        self._in_tick = True
        self._tick_committed = 0
        try:
            return self._step_inner()
        finally:
            if self._faults is not None:
                # double-release fault: push an already-freed slot through
                # the release path again; the flush must absorb it as a
                # counted warning and the device release as a no-op
                cand = (list(self._pending_release)
                        or [s for s in range(self.pool.slots)
                            if s not in self.scheduler.active])
                if cand and self._faults.take(DOUBLE_RELEASE, self._tick_no):
                    self._pending_release.append(self._faults.choose(cand))
            self._flush_releases()
            self._in_tick = False
            if obs is not None:
                sch = self.scheduler
                obs.tick(
                    start=t_start, now=sch.clock(), tick_no=self._tick_no,
                    committed=self._tick_committed,
                    queue_depth=len(sch.queue), active=len(sch.active),
                    slots=self.pool.slots, counters=self.fault_counters,
                    free_blocks=(self._alloc.free_blocks()
                                 if self._alloc is not None else None),
                    n_phys=(self.pool.n_phys
                            if self._alloc is not None else 0),
                    evictions=(self._alloc.evictions
                               if self._alloc is not None else 0),
                    trie_blocks=(len(self._trie)
                                 if self._trie is not None else 0),
                    spec_hist=(self.spec_hist.tolist()
                               if self._spec is not None else None))

    def _flush_releases(self) -> None:
        """Recycle every pending slot in one replay of the ``release``
        entry (a host-padded ``[slots]`` vector, ``-1`` where nothing is
        released).

        A slot pending twice, or pushed again after an earlier flush, is
        found against the ``_slot_live`` mirror and counted as a
        ``double_release``: its allocator decref is skipped (host
        refcounts stay exact) while the device release, a masked no-op on
        a free slot, still gets every unique slot."""
        if not self._pending_release:
            return
        seen = list(dict.fromkeys(self._pending_release))   # ordered unique
        doubles = len(self._pending_release) - len(seen)
        live = []
        for s in seen:
            if self._slot_live[s]:
                self._slot_live[s] = False
                self._gens[s] = None
                live.append(s)
            else:
                doubles += 1
        self._pending_release = []
        self.fault_counters["double_release"] += doubles
        vec = np.full(self.pool.slots, -1, np.int32)
        vec[:len(seen)] = seen
        fwd = self._entry("release")
        fwd.set(slots=vec)
        fwd.run()
        if self._alloc is not None:
            for s in live:
                ids = self._blocks.pop(s, [])
                if ids:
                    self._alloc.decref(ids)
                self._reserved.pop(s, None)

    def _admit_paged(self, now: float):
        """Reservation + prefix-hit admission of the queue's head.

        Returns the admitted request, or None (the request stays queued,
        backing off) when the arena cannot guarantee its worst-case page
        demand on top of every admitted request's outstanding reservation —
        the paged analogue of running out of slots — or when the plan
        injects that pressure.  On admission a prefix-trie hit points the
        slot's table row at the shared blocks and skips their prefill."""
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
        exhausted = need + revived + outstanding > alloc.free_blocks()
        if (not exhausted and self._faults is not None
                and self._faults.take(PAGE_EXHAUSTION, self._tick_no)):
            # injected arena pressure: behave as if no page were free
            self.fault_counters["injected_page_exhaustion"] += 1
            exhausted = True
        if exhausted:
            sch.defer_admission(now)       # head-of-line: FIFO preserved
            self.fault_counters["deferred"] += 1
            return None
        req = sch.admit(now)
        if self._obs is not None and sch.chunk is not None:
            self._obs.prefix_match(len(hits), plen // bs)
        self._reserved[req.slot] = need
        self._blocks[req.slot] = list(hits)
        if hits:
            alloc.incref(hits)
            ids = np.zeros(self.pool.max_blocks, np.int64)
            ids[:len(hits)] = hits
            fwd = self._entry("assign")
            fwd.set(slot=[req.slot], ids=ids, n=[len(hits)])
            fwd.run()
            req.prefill_done = len(hits) * bs   # shared prefix: no prefill
            self._tail_len[req.slot] = 0
        return req

    def _set_lane(self, slot: int, params: SamplingParams) -> None:
        """Write an admitted request's sampling lane through the
        ``set_lane`` entry (its values as device operands) and keep its
        generator and sort branch on the host."""
        fwd = self._entry("set_lane")
        fwd.set(slot=[slot], temperature=[params.temperature],
                top_k=[params.top_k], top_p=[params.top_p])
        fwd.run()
        self._gens[slot] = (
            sampling.request_generator(params, self.device)
            if params.temperature > 0 else None)
        self._exact[slot] = sampling.needs_exact_sort(params, self.cfg.vocab)

    def _step_inner(self) -> List[RequestOutput]:
        events: List[RequestOutput] = []
        sch = self.scheduler
        # expiry, then the release flush, then admission: a pending release
        # never lands on a slot a new request just took
        now = sch.clock()
        self._expire_deadlines(now, events)
        self._flush_releases()
        while sch.queue and sch.free_slots():
            if sch.queue[0].next_admit > now:
                break                          # head backing off: FIFO waits
            req = (sch.admit(now) if self._alloc is None
                   else self._admit_paged(now))
            if req is None:
                break                          # arena full: wait for releases
            self._set_lane(req.slot, req.params)
            self._slot_live[req.slot] = True

        # cancellation-mid-prefill fault: kill a partly prefilled request
        # between its chunks
        if self._faults is not None:
            mid = [r for r in sch.active.values()
                   if 0 < r.prefill_done < len(r.prompt)]
            if mid and self._faults.take(CANCEL_PREFILL, self._tick_no):
                out = self._cancel_inner(self._faults.choose(mid).rid)
                if out is not None:
                    events.append(out)

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
        t_dec = sch.clock() if self._obs is not None else 0.0
        tokens = torch.zeros((b, 1), dtype=torch.long)
        mask = [False] * b
        for s in slots:
            tokens[s, 0] = self._last_tok[s]
            mask[s] = True
        logits = self._panel_logits("decode", tokens, mask)
        tok, logp = sampling.sample_step(logits[:, 0], self.lanes,
                                         self._gens, mask,
                                         self._exact_for(mask))
        picked, logps = self._tokens(tok), logp.tolist()
        if self._obs is not None:
            # dispatch through the token read
            self._obs.decode_tick(t_dec, sch.clock() - t_dec, len(slots),
                                  spec=False)
        for s in slots:
            if s not in sch.active:
                continue      # cancelled by a callback: the token dies
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
        t_dec = sch.clock() if self._obs is not None else 0.0
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
        new_rec = {**self._to_host(tok=self._with_err(tok), logp=logp,
                                   ncommit=None),
                   "tok_shape": tuple(tok.shape), "chain": tok, "dlen": None,
                   "slots": [(s, sch.active[s].rid) for s in slots],
                   "t0": t_dec}
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

    def _with_err(self, tok: torch.Tensor) -> torch.Tensor:
        """``tok`` with the sanitized pool's error word appended (flat), so
        that one device-to-host copy carries both; ``tok`` itself on an
        unchecked pool."""
        err = self.state.get("err")
        if err is None:
            return tok
        return torch.cat([tok.reshape(-1), err.to(tok.dtype)])

    def _split_err(self, host: torch.Tensor, shape) -> list:
        """The tokens (as a list of ``shape``) from the host copy of
        :meth:`_with_err`; raises :class:`~.cache_pool.PoolCheckError`,
        naming every failed check, when the word has a bit set (and clears
        the device word, so each failure is raised once)."""
        err = self.state.get("err")
        if err is None:
            return host.tolist()
        word = int(host[-1])
        if word:
            err.zero_()
            check_errors(word)
        return host[:-1].reshape(shape).tolist()

    def _tokens(self, tok: torch.Tensor) -> list:
        """The tick's token read (``tok.tolist()``), the error word read in
        the same copy."""
        return self._split_err(self._with_err(tok).cpu(), tuple(tok.shape))

    def _sync_inflight(self, events: List[RequestOutput]) -> None:
        """Commit the in-flight tick's token window: the overlapped
        pipeline's one sync.  Each slot's ``(slot, rid)`` is checked again:
        a request that finished, was cancelled or expired, or whose slot
        was taken by another, while its window was in flight has the
        window dropped (its appends were dead writes, wiped by the
        release).  No-op when nothing is in flight."""
        rec, self._inflight = self._inflight, None
        if rec is None:
            return
        sch = self.scheduler
        if rec["ready"] is not None:
            rec["ready"].synchronize()
        picked = self._split_err(rec["tok"], rec["tok_shape"])
        logps = rec["logp"].tolist()
        ncs = rec["ncommit"].tolist() if rec["ncommit"] is not None else None
        if self._obs is not None:
            # dispatch to the delayed read: the device's wall time, host
            # work included only where it failed to hide
            self._obs.decode_tick(rec["t0"], sch.clock() - rec["t0"],
                                  len(rec["slots"]), spec=ncs is not None,
                                  overlapped=True)
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
            logits, fwd.inputs["tokens"],
            dlen.to(self.device, non_blocking=True), self.lanes, self._gens,
            mask, self._exact_for(mask))
        self.pool.rollback(self.state,
                           qn * fwd.inputs["mask"].to(torch.int32) - nc)
        return tok, logp, nc

    def _spec_tick(self, slots: List[int],
                   events: List[RequestOutput]) -> List[RequestOutput]:
        """One draft-verify tick over every decoding slot.

        Each live slot's drafter proposes up to ``k`` continuations of its
        request's history, clamped to the slot's tail headroom (a verify
        appends ``k + 1`` tokens before the accept, and the kept ones must
        fit the ring; a nearly full tail speculates less and the refreeze
        keeps working unchanged) and, when adaptive, to the slot's window.
        In degraded mode (the queue at ``degrade_queue`` or more) every
        slot drafts nothing, and a drafter that raises leaves its slot
        draftless: the same ``[slots, k+1]`` verify graph then commits one
        token for it.  One verify scores the panel; each slot then commits
        its window with the stop scan inside it."""
        sch = self.scheduler
        t_dec = sch.clock() if self._obs is not None else 0.0
        b, k = self.pool.slots, self._spec.k
        degraded = (self._degrade_queue > 0
                    and len(sch.queue) >= self._degrade_queue)
        if degraded:
            self.fault_counters["degraded_ticks"] += 1
        tokens = torch.zeros((b, k + 1), dtype=torch.long)
        mask = [False] * b
        dlen = torch.zeros(b, dtype=torch.long)
        for s in slots:
            req = sch.active[s]
            tokens[s, 0] = self._last_tok[s]
            mask[s] = True
            cap = 0 if degraded else min(
                k, self.pool.tail - 1 - int(self._tail_len[s]))
            if self._adaptive is not None and not degraded:
                cap = min(cap, self._adaptive.draft_len(s))
            if cap > 0:
                try:
                    if (self._faults is not None
                            and self._faults.take(DRAFTER_ERROR,
                                                  self._tick_no)):
                        self._faults.raise_fault(DRAFTER_ERROR)
                    drafts = self.drafter.propose(
                        req.prompt + req.generated, cap)
                except Exception:
                    # a failing drafter leaves its slot draftless for this
                    # tick, never the engine
                    self.fault_counters["drafter_error"] += 1
                    drafts = []
                dlen[s] = len(drafts)
                tokens[s, 1:1 + len(drafts)] = torch.tensor(
                    drafts, dtype=torch.long)
        slot_rids = [(s, sch.active[s].rid) for s in slots]
        tok, logp, ncommit = self._verify(tokens, mask, dlen)
        # cancellation-mid-spec-window fault: the victim's drafts were
        # verified but its window has not committed; it is dropped with
        # the slot
        if self._faults is not None:
            alive = [s for s in slots if s in sch.active]
            if alive and self._faults.take(CANCEL_SPEC, self._tick_no):
                out = self._cancel_inner(
                    sch.active[self._faults.choose(alive)].rid)
                if out is not None:
                    events.append(out)
        if self.overlap:
            # dispatched, not synced: the window commits at the next
            # tick's _sync_inflight, which drops it for a dead request
            self._inflight = {**self._to_host(tok=self._with_err(tok),
                                              logp=logp, ncommit=ncommit),
                              "tok_shape": tuple(tok.shape), "dlen": dlen,
                              "slots": slot_rids, "t0": t_dec}
            return events
        picked, logps, ncs = (self._tokens(tok), logp.tolist(),
                              ncommit.tolist())
        if self._obs is not None:
            # drafting and the verify dispatch through the token read
            self._obs.decode_tick(t_dec, sch.clock() - t_dec, len(slots),
                                  spec=True)
        for s in slots:
            if s not in sch.active:
                continue      # cancelled inside the window: never committed
            nc = ncs[s]
            self._tail_len[s] += nc          # t0 + accepted stay appended
            self.spec_hist[nc - 1] += 1      # nc - 1 = accepted drafts
            if self._adaptive is not None:
                self._adaptive.update(s, int(dlen[s]), nc - 1)
            self._emit(s, picked[s][:nc], logps[s][:nc], events)
        return events

    def _refreeze_tick(self, events: Optional[List[RequestOutput]] = None
                       ) -> None:
        """Refreeze every slot whose tail ring is full, through the
        ``refreeze`` entry.  The host mirror matches the device-side
        ``tail_len == tail`` exactly, so the host decides whether to fold
        (and which slots get pages) and the device finds the same slots
        itself: nothing waits for the device."""
        full = [s for s in range(self.pool.slots)
                if self._tail_len[s] >= self.pool.tail]
        if not full:
            return
        fwd = self._entry("refreeze")
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
            fwd.set(ids=ids)
        fwd.run()
        for s in full:
            self._tail_len[s] = 0

    def _prefill_tick(self, events: List[RequestOutput]) -> None:
        """One prefill chunk for the oldest request still owed prompt work,
        through the ``prefill_chunk`` entry of its width class (the chunk
        length rounded up to whole blocks, the rest padding).  Only the
        final chunk waits for the device: it samples the request's first
        token from the entry's logits and reads it."""
        sch, bs = self.scheduler, self.pool.bs
        req = sch.next_prefill()
        if req is None:
            return
        t_pf = sch.clock() if self._obs is not None else 0.0
        off0 = req.prefill_done
        chunk = sch.prefill_chunk(req)
        final = req.prefill_done >= len(req.prompt)
        n = len(chunk)
        w = self._width(n)
        toks = np.zeros((1, w), np.int64)
        toks[0, :n] = chunk
        fwd = self._entry("prefill_chunk", w)
        fresh = None
        if self._alloc is not None:
            fresh = self._alloc.alloc(n // bs)
            ids = np.zeros(w // bs, np.int64)
            ids[:len(fresh)] = fresh
            fwd.set(ids=ids)
        fwd.set(tokens=toks, slot=[req.slot], length=[n])
        logits = fwd.run()
        if fresh is not None:
            self._blocks.setdefault(req.slot, []).extend(fresh)
            self._reserved[req.slot] = max(
                0, self._reserved.get(req.slot, 0) - len(fresh))
            # content-address the new blocks only when the chunk ran at
            # full width: block bytes depend on the whole token prefix AND
            # the chunk boundaries, so only full-width-chunk blocks are
            # reproducible by a later prompt prefilled the same way
            if sch.chunk is not None and n == sch.chunk:
                hs = block_hashes(req.prompt[:req.prefill_done], bs)
                for i, bid in enumerate(fresh):
                    h = hs[off0 // bs + i]
                    if self._alloc.register(bid, h):
                        self._trie.insert(h, bid)
        # device tail_len after a chunk = chunk_len % bs (earlier chunks are
        # block-aligned)
        self._tail_len[req.slot] = req.prefill_done % bs
        if final:
            s = req.slot
            lane = {k: v[s:s + 1] for k, v in self.lanes.items()}
            tok, logp = sampling.sample_step(logits, lane, [self._gens[s]],
                                             [True], self._exact[s])
            self._emit(s, self._tokens(tok), [float(logp[0])], events)
        if self._obs is not None:
            # a non-final chunk is its dispatch; the final one includes
            # the first token's read
            self._obs.prefill_chunk(req.rid, req.slot, t_pf,
                                    sch.clock() - t_pf, n, final)

    def _emit(self, slot: int, toks: List[int], logprobs: List[float],
              events: List[RequestOutput]) -> None:
        """Commit one tick's token window for a slot (one token, or an
        accepted window under speculation; one snapshot either way);
        recycle the slot if that finished the request."""
        req = self.scheduler.active[slot]
        prefill = not req.generated
        before = len(req.generated)
        finished = self.scheduler.record_tokens(
            slot, toks, logprobs, decode_tick=not prefill) is not None
        # a stop inside a speculative window truncates the commit: count
        # what landed
        self._tick_committed += len(req.generated) - before
        out = req.output()
        events.append(out)
        cb = self._callbacks.get(req.rid)
        if cb is not None:
            cb(out)
        if finished:
            if self._obs is not None:
                self._obs.request_finished(out, self.scheduler.clock())
            self._callbacks.pop(req.rid, None)
            self._pending_release.append(slot)
            self._tail_len[slot] = 0
            self._last_tok.pop(slot, None)
            if self._adaptive is not None:
                self._adaptive.reset(slot)   # the next tenant starts fresh
        elif req.finish_reason is None:
            # a cancel from this request's own callback already reset the
            # slot's mirrors
            self._last_tok[slot] = req.generated[-1]
