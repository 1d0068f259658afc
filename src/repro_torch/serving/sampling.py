"""Request-level sampling (twin of ``repro.serving.sampling``):
``SamplingParams`` in, ``RequestOutput`` out, and the per-slot sampler
between them (``sample_step``, and ``accept_step`` for speculation).

Every pool slot carries a sampling *lane* (``temperature`` / ``top_k`` /
``top_p`` tensors on the device) and, for seeded sampling, the request's
own ``torch.Generator``.  ``temperature == 0`` is exactly ``argmax`` (first
index on ties).

**RNG contract.**  The reference keeps threefry keys in device lanes.  Here
each request gets its own ``torch.Generator`` seeded from
``SamplingParams.seed`` at admission, and it advances only on that
request's own draws (the final prefill chunk's first token, then one draw
per decode tick, or under speculation ``Qn - 1`` uniforms and one draw per
verify tick: :func:`accept_step`).  A request's token stream therefore
depends on its seed and its own tick count, never on its slot or its
co-tenants — the reference's contract — but the streams are not the
reference's bits: tests hold the masking exactly and the draw by
distribution.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch


# ---------------------------------------------------------------------------
# request-level API objects
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding contract (fields and checks as the reference).

    temperature: 0 = greedy (exact argmax); > 0 scales logits.
    top_k: keep the k highest logits (0 = disabled).
    top_p: nucleus mass (1.0 = disabled).
    seed: seeds the request's generator; same seed => same tokens,
      whatever the slot or co-tenants.
    max_new_tokens: generation budget (includes the prefill's token).
    eos_id / stop_ids: stop token / stop sequences (kept in the output).
    deadline_s / ttft_deadline_s: wall-clock budgets (the port's engine
      does not enforce deadlines yet and rejects requests that set them).
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    stop_ids: Tuple[Tuple[int, ...], ...] = ()
    deadline_s: Optional[float] = None
    ttft_deadline_s: Optional[float] = None

    def __post_init__(self):
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0: {self.deadline_s}")
        if self.ttft_deadline_s is not None and self.ttft_deadline_s <= 0:
            raise ValueError(
                f"ttft_deadline_s must be > 0: {self.ttft_deadline_s}")
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0: {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0: {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1]: {self.top_p}")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1: {self.max_new_tokens}")
        norm = tuple(
            (int(s),) if isinstance(s, int) else tuple(int(t) for t in s)
            for s in self.stop_ids)
        if any(not s for s in norm):
            raise ValueError("empty stop sequence")
        object.__setattr__(self, "stop_ids", norm)

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


@dataclasses.dataclass(frozen=True)
class RequestMetrics:
    """Wall-clock timing + decode accounting of one request
    (``time.monotonic`` seconds)."""
    arrival_time: float
    first_token_time: Optional[float]
    finished_time: Optional[float]
    decode_ticks: int = 0
    num_generated: int = 0
    admitted_time: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def queue_time(self) -> Optional[float]:
        if self.admitted_time is None:
            return None
        return self.admitted_time - self.arrival_time

    @property
    def prefill_time(self) -> Optional[float]:
        if self.admitted_time is None or self.first_token_time is None:
            return None
        return self.first_token_time - self.admitted_time

    @property
    def decode_time(self) -> Optional[float]:
        if self.first_token_time is None or self.finished_time is None:
            return None
        return self.finished_time - self.first_token_time

    @property
    def tpot(self) -> Optional[float]:
        if (self.finished_time is None or self.first_token_time is None
                or self.num_generated <= 1):
            return None
        return ((self.finished_time - self.first_token_time)
                / (self.num_generated - 1))

    @property
    def e2e_latency(self) -> Optional[float]:
        if self.finished_time is None:
            return None
        return self.finished_time - self.arrival_time

    @property
    def accepted_per_tick(self) -> Optional[float]:
        if self.decode_ticks <= 0:
            return None
        return (self.num_generated - 1) / self.decode_ticks

    @property
    def decode_tok_s(self) -> Optional[float]:
        if (self.finished_time is None or self.first_token_time is None
                or self.num_generated <= 1):
            return None
        dt = self.finished_time - self.first_token_time
        if dt <= 0:
            return None
        return (self.num_generated - 1) / dt


@dataclasses.dataclass(frozen=True)
class RequestOutput:
    """Snapshot of one request's generation state; ``logprobs[i]`` is the
    chosen token's ``log_softmax(logits)`` before any shaping."""
    request_id: int
    prompt_token_ids: Tuple[int, ...]
    token_ids: Tuple[int, ...]
    finish_reason: Optional[str]
    metrics: RequestMetrics
    logprobs: Tuple[Optional[float], ...] = ()

    @property
    def finished(self) -> bool:
        return self.finish_reason is not None


# ---------------------------------------------------------------------------
# sampling lanes
# ---------------------------------------------------------------------------

def init_lanes(slots: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Zeroed lanes: every slot starts greedy."""
    return {
        "temperature": torch.zeros(slots, dtype=torch.float32, device=device),
        "top_k": torch.zeros(slots, dtype=torch.int32, device=device),
        "top_p": torch.ones(slots, dtype=torch.float32, device=device),
    }


def broadcast_lanes(params: SamplingParams, batch: int,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """Uniform lanes for a static batch (the one-shot engine): every row
    shares ``params``; with the same seed, as the reference's rows share
    the key (rows are independent requests decoded lockstep)."""
    return {
        "temperature": torch.full((batch,), float(params.temperature),
                                  dtype=torch.float32, device=device),
        "top_k": torch.full((batch,), int(params.top_k), dtype=torch.int32,
                            device=device),
        "top_p": torch.full((batch,), float(params.top_p),
                            dtype=torch.float32, device=device),
    }


def request_generator(params: SamplingParams,
                      device: torch.device) -> torch.Generator:
    """The per-request generator — seeded from the request alone."""
    g = torch.Generator(device=device)
    g.manual_seed(int(params.seed))
    return g


def set_lane(lanes: Dict[str, torch.Tensor], slot: torch.Tensor,
             temperature: torch.Tensor, top_k: torch.Tensor,
             top_p: torch.Tensor, write: torch.Tensor) -> None:
    """Write one slot's lane at admission, in place (the twin of the
    reference's ``set_lane``).  Every operand is a ``[1]`` tensor on the
    lanes' device (``slot`` int64, ``write`` bool, the values in their
    lane's dtype), so the engine captures this once and any request
    replays it; a false ``write`` writes the lane back as it was."""
    for key, value in (("temperature", temperature), ("top_k", top_k),
                       ("top_p", top_p)):
        lane = lanes[key]
        lane.index_copy_(0, slot, torch.where(
            write, value, lane.index_select(0, slot)))


# ---------------------------------------------------------------------------
# masking
# ---------------------------------------------------------------------------

TOPP_BUCKET = 128


def _logsumexp_kept(kept: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(kept, dim=-1, keepdim=True)


def _mask_logits_sorted(scaled: torch.Tensor, top_k: torch.Tensor,
                        top_p: torch.Tensor) -> torch.Tensor:
    """Exact full-sort masker (twin of the reference's)."""
    v = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.clamp(torch.where(top_k > 0, top_k, torch.full_like(top_k, v)),
                    1, v).long()
    kth = torch.gather(sorted_desc, -1, (k - 1)[:, None])
    ninf = torch.full((), float("-inf"), device=scaled.device)
    kept = torch.where(scaled < kth, ninf, scaled)
    sorted_kept = torch.where(sorted_desc < kth, ninf, sorted_desc)
    denom = _logsumexp_kept(kept)
    probs = torch.exp(sorted_kept - denom)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    in_nucleus = cum_before < top_p[:, None]
    cutoff = torch.where(in_nucleus, sorted_desc,
                         torch.full((), float("inf"), device=scaled.device)
                         ).amin(-1, keepdim=True)
    # a sequential f32 cumsum can reach 1.0 before the row ends; top_p == 1
    # stays the exact no-op the contract promises (as in the bucketed path)
    cutoff = torch.where((top_p >= 1.0)[:, None], ninf, cutoff)
    return torch.where(kept < cutoff, ninf, kept)


def _mask_logits_bucketed(scaled: torch.Tensor, top_k: torch.Tensor,
                          top_p: torch.Tensor, kb: int) -> torch.Tensor:
    """Threshold top-k / top-p from a ``kb``-entry top bucket (twin of the
    reference's sort-free path)."""
    top_vals = torch.topk(scaled, kb, dim=-1).values              # sorted
    k = torch.clamp(top_k, 1, kb).long()
    ninf = torch.full((), float("-inf"), device=scaled.device)
    kth = torch.gather(top_vals, -1, (k - 1)[:, None])
    kth = torch.where((top_k > 0)[:, None], kth, ninf)
    kept = torch.where(scaled < kth, ninf, scaled)
    denom = _logsumexp_kept(kept)
    bucket_kept = torch.where(top_vals < kth, ninf, top_vals)
    probs = torch.exp(bucket_kept - denom)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    in_nucleus = cum_before < top_p[:, None]
    cutoff = torch.where(in_nucleus, top_vals,
                         torch.full((), float("inf"), device=scaled.device)
                         ).amin(-1, keepdim=True)
    cutoff = torch.where((top_p >= 1.0)[:, None], ninf, cutoff)
    return torch.where(kept < cutoff, ninf, kept)


def needs_exact_sort(params: SamplingParams, v: int) -> bool:
    """Whether a lane under ``params`` needs the exact full sort over a
    ``v``-entry vocabulary (unbounded support): the host's copy of the
    branch :func:`_mask_logits` takes, decided from the request alone."""
    kb = min(v, TOPP_BUCKET)
    return kb == v or params.top_k > kb or (params.top_k == 0
                                            and params.top_p < 1.0)


def _mask_logits(logits: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor,
                 live: Optional[torch.Tensor] = None,
                 exact: Optional[bool] = None) -> torch.Tensor:
    """Temperature -> top-k -> top-p over the lane axis; at least one token
    survives.  The exact full sort runs only when a live lane needs
    unbounded support (the reference's ``lax.cond``; here a host branch).
    ``exact`` is that branch decided by the caller from the live requests'
    parameters (:func:`needs_exact_sort`); without it the lanes on the
    device decide, which waits for the device."""
    v = logits.shape[-1]
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    kb = min(v, TOPP_BUCKET)
    if kb == v:
        return _mask_logits_sorted(scaled, top_k, top_p)
    if exact is None:
        needs_exact = (top_k > kb) | ((top_k == 0) & (top_p < 1.0))
        if live is not None:
            needs_exact = needs_exact & live
        exact = bool(needs_exact.any())
    if exact:
        return _mask_logits_sorted(scaled, top_k, top_p)
    return _mask_logits_bucketed(scaled, top_k, top_p, kb)


def lane_mask(b: int, lanes: Sequence[int],
               device: torch.device) -> torch.Tensor:
    """A bool ``[b]`` mask of ``lanes``, built on the host and copied
    without waiting for the device."""
    keep = set(lanes)
    return torch.tensor([i in keep for i in range(b)]).to(device,
                                                          non_blocking=True)


def _categorical(probs: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """One draw from ``probs [V]`` as ``torch.multinomial(probs, 1)`` makes
    it (the exponential race ``argmax(p / E)``, ``E ~ Exp(1)``: the same
    draw from the same generator state), without its host-side validity
    check, which waits for the device.  Returns int64 ``[1]``."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q).reshape(1)


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

def sample_step(logits: torch.Tensor, lanes: Dict[str, torch.Tensor],
                generators: Sequence[Optional[torch.Generator]],
                advance: Sequence[bool], exact: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw one token per lane.

    ``logits [B, V]``; ``generators[b]`` is lane ``b``'s request generator,
    present only for sampled (``temperature > 0``) requests and None for
    greedy or free lanes; ``advance[b]`` marks the lanes whose draw is
    consumed — only those draw, so a request's generator advances exactly
    once per token it samples.  ``exact`` is the masker's branch (see
    :func:`_mask_logits`).  Returns ``(tokens int64 [B], chosen-token
    logprobs f32 [B])``, fresh tensors; greedy lanes are
    ``argmax(logits)``.  Nothing here waits for the device."""
    logits = logits.to(torch.float32)
    temp = lanes["temperature"]
    tok = torch.argmax(logits, dim=-1)
    sampled = [b for b in range(logits.shape[0])
               if advance[b] and generators[b] is not None]
    if sampled:
        live = lane_mask(logits.shape[0], sampled, logits.device)
        masked = _mask_logits(logits, temp, lanes["top_k"], lanes["top_p"],
                              live=live, exact=exact)
        probs = torch.softmax(masked, dim=-1)
        for b in sampled:
            tok[b] = _categorical(probs[b], generators[b])[0]
    logp = torch.log_softmax(logits, dim=-1)
    chosen = torch.gather(logp, -1, tok[:, None])[:, 0]
    return tok, chosen


# ---------------------------------------------------------------------------
# speculative acceptance (the verify half of draft-verify decoding)
# ---------------------------------------------------------------------------

def accept_step(logits: torch.Tensor, tokens: torch.Tensor,
                draft_len: torch.Tensor, lanes: Dict[str, torch.Tensor],
                generators: Sequence[Optional[torch.Generator]],
                live: Sequence[bool], exact: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-lane acceptance over a verified draft window (twin of the
    reference's ``accept_step``).

    ``logits [B, Qn, V]`` — the verify forward's panel logits
    (``logits[:, j]`` conditions on the panel through position ``j``);
    ``tokens [B, Qn]`` — the panel (last committed token, then the drafts,
    padded); ``draft_len [B]`` — valid drafts per slot (0..Qn-1);
    ``generators`` / ``live`` / ``exact`` as ``sample_step``'s
    ``generators`` / ``advance`` / ``exact``.

    Greedy lanes accept a draft exactly when it is the argmax of the
    logits it was drafted to follow, so the committed stream is the plain
    engine's.  Sampled lanes run rejection sampling against the lane's
    masked, temperature-scaled distribution ``p``: the drafter is a point
    mass, so draft ``d`` is accepted with probability ``p(d)`` and a
    rejection draws from ``p`` with ``d`` excluded (the renormalised
    residual); after the last accepted draft a plain draw from ``p``
    follows.  The output distribution is the plain sampler's, token by
    token.  A sampled lane draws ``Qn - 1`` uniforms and one categorical
    per tick from its request's own generator.

    Returns ``(out_tok int64 [B, Qn], out_logp f32 [B, Qn], n_commit
    int32 [B])``: slot ``b`` commits ``out_tok[b, :n_commit[b]]``
    (``n_commit = accepted + 1``; masked slots commit 0).  ``out_logp`` is
    the chosen token's log-probability under the unmodified distribution,
    as in ``sample_step``; the outputs are fresh tensors and nothing here
    waits for the device."""
    b, qn, v = logits.shape
    logits = logits.to(torch.float32)
    dev = logits.device
    tokens = tokens.to(dev, non_blocking=True).long()
    draft_len = torch.as_tensor(draft_len).to(dev, non_blocking=True).long()
    live_t = lane_mask(b, [i for i in range(b) if live[i]], dev)
    greedy_tok = torch.argmax(logits, dim=-1)                    # [B, Qn]
    draft_next = tokens[:, 1:]                                   # [B, Qn-1]
    acc = greedy_tok[:, :-1] == draft_next
    sampled = [i for i in range(b) if live[i] and generators[i] is not None]
    if sampled:
        lane_live = lane_mask(b, sampled, dev)
        masked = torch.stack([_mask_logits(
            logits[:, j], lanes["temperature"], lanes["top_k"],
            lanes["top_p"], live=lane_live, exact=exact)
            for j in range(qn)], 1)
        p_draft = torch.gather(torch.softmax(masked[:, :-1], dim=-1), -1,
                               draft_next[..., None])[..., 0]
        for i in sampled:
            u = torch.rand(qn - 1, generator=generators[i], device=dev)
            acc[i] = u < p_draft[i]
    acc &= torch.arange(qn - 1, device=dev)[None] < draft_len[:, None]
    accepted = torch.cumprod(acc.long(), dim=1).sum(dim=1)       # [B]
    jidx = torch.arange(qn, device=dev)
    dpad = torch.cat([draft_next, torch.full((b, 1), -1, dtype=torch.long,
                                             device=dev)], 1)
    out_tok = torch.where(jidx[None] < accepted[:, None], dpad, greedy_tok)
    ninf = torch.full((), float("-inf"), device=dev)
    for i in sampled:
        # the correction (a rejected draft is excluded) or the bonus draw,
        # at position ``accepted`` — selected on the device, no host sync
        a = accepted[i:i + 1]
        row = torch.index_select(masked[i], 0, a)[0]             # [V]
        excl = ((torch.arange(v, device=dev) == dpad[i, a])
                & (a < draft_len[i]))
        cand = _categorical(torch.softmax(torch.where(excl, ninf, row),
                                          dim=-1), generators[i])
        out_tok[i] = torch.where(jidx == a, cand, out_tok[i])
    out_logp = torch.gather(torch.log_softmax(logits, dim=-1), -1,
                            out_tok.clamp(min=0)[..., None])[..., 0]
    n_commit = torch.where(live_t, accepted + 1,
                           torch.zeros_like(accepted)).to(torch.int32)
    return out_tok, out_logp, n_commit
