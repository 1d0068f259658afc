"""Deterministic fault injection for the serving engine (a copy of
``repro.serving.faults``, numpy only).

A :class:`FaultPlan` is a seeded schedule of faults fired at **named
host-side sites** inside :class:`~repro_torch.serving.engine.ContinuousEngine`'s
tick loop.  The engine consults the plan at each site (a dict lookup — no
device work, no extra captures) and the plan decides whether the fault
fires this tick; the contract under test is that the engine *survives the
whole plan*: every request finishes with a valid ``finish_reason``,
refcounts on the host and the device return to zero, no entry is captured
twice, and requests the plan did not touch stay token-identical to a
fault-free run.

Sites (the first five are engine-integrated; the last two are harness
fixtures exercised by the tests/benchmarks):

``page-exhaustion``
    Admission-time arena pressure: the paged reservation check behaves as
    if no physical blocks were free, so the queue head is deferred through
    the scheduler's exponential-backoff requeue path.
``drafter-error``
    The speculative drafter raises mid-propose; the engine must degrade
    that slot to a draftless tick (one committed token), never crash.
``cancel-prefill``
    A request with partially-prefilled prompt state is cancelled between
    its chunks; its slot and pages must come back without perturbing
    co-tenant token streams.
``cancel-spec``
    A decoding request is cancelled *inside* the draft–verify window —
    after its drafts were built into the verify panel, before the window
    commits.  The verified tokens must be discarded, the slot released.
``double-release``
    An already-free slot is pushed through the release path again; the
    device transition is an idempotent no-op and the engine counts a
    warning instead of underflowing a refcount.
``snapshot-corruption``
    Not an engine site: :func:`corrupt_snapshot` truncates or scribbles
    over a saved prefix-cache snapshot so restore paths can prove they
    fail with a readable :class:`ValueError`, never a half-restore.
``deadline-race``
    Not an engine site: the harness submits requests whose wall-clock
    deadline expires the same tick EOS lands, pinning the precedence rule
    (a committed stop beats a later deadline check).

Everything here is host-side control flow: no torch imports, nothing
touches the captured entries, and the plan is a pure function of its
seed — the same seed replays the same faults against the same wave.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

# engine-integrated sites
PAGE_EXHAUSTION = "page-exhaustion"
DRAFTER_ERROR = "drafter-error"
CANCEL_PREFILL = "cancel-prefill"
CANCEL_SPEC = "cancel-spec"
DOUBLE_RELEASE = "double-release"
ENGINE_SITES: Tuple[str, ...] = (
    PAGE_EXHAUSTION, DRAFTER_ERROR, CANCEL_PREFILL, CANCEL_SPEC,
    DOUBLE_RELEASE)
# harness-level fixtures (documented above; not consulted by the engine)
SNAPSHOT_CORRUPTION = "snapshot-corruption"
DEADLINE_RACE = "deadline-race"
ALL_SITES: Tuple[str, ...] = ENGINE_SITES + (SNAPSHOT_CORRUPTION,
                                             DEADLINE_RACE)


class FaultError(RuntimeError):
    """The exception an injected fault raises (e.g. inside the drafter)."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault: fire ``site`` at the first *applicable* engine
    tick ``>= tick`` (a cancel site waits until a victim exists; an
    admission site waits until something is queued)."""
    site: str
    tick: int

    def __post_init__(self):
        if self.site not in ALL_SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; known: {ALL_SITES}")
        if self.tick < 0:
            raise ValueError(f"fault tick must be >= 0: {self.tick}")


class FaultPlan:
    """A seeded, replayable schedule of :class:`Fault`\\ s.

    The engine calls :meth:`take` at each site with its current tick
    number; the plan pops the oldest matching fault whose scheduled tick
    has arrived.  Victim selection (which request a cancel site kills)
    goes through :meth:`choose`, drawn from the plan's own seeded RNG so
    an identical (seed, wave) pair replays identical faults.  ``fired``
    records ``(tick, site)`` for every fault that actually landed —
    the test harness asserts the plan drained (:meth:`exhausted`).

    ``on_fire`` is an optional ``(site, tick) -> None`` observer invoked
    on every firing — the engine points it at the observability layer so
    injected faults land on the request-lifecycle trace timeline.  It
    must stay a pure observer: the plan's decisions never depend on it.
    """

    def __init__(self, faults: Sequence[Fault] = (), seed: int = 0):
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._pending: List[Fault] = sorted(faults, key=lambda f: f.tick)
        self.fired: List[Tuple[int, str]] = []
        self.on_fire = None              # set by the engine when obs is on

    @classmethod
    def generate(cls, seed: int, ticks: int = 24,
                 sites: Optional[Sequence[str]] = None,
                 per_site: int = 1) -> "FaultPlan":
        """A deterministic plan from a seed: ``per_site`` firings of every
        engine-integrated site, scattered over ``[1, ticks)``."""
        rng = np.random.default_rng(seed)
        faults = []
        for site in (sites if sites is not None else ENGINE_SITES):
            for t in rng.integers(1, max(ticks, 2), size=per_site):
                faults.append(Fault(site, int(t)))
        return cls(faults, seed=seed)

    # -- engine-facing API --------------------------------------------------
    def take(self, site: str, tick: int) -> bool:
        """Pop (and record) the oldest pending ``site`` fault due by
        ``tick``.  Returns whether one fired."""
        for i, f in enumerate(self._pending):
            if f.site == site and f.tick <= tick:
                del self._pending[i]
                self.fired.append((tick, site))
                if self.on_fire is not None:
                    self.on_fire(site, tick)
                return True
        return False

    def choose(self, options: Sequence):
        """Seeded victim selection among ``options`` (deterministic for a
        fixed seed and call sequence)."""
        if not options:
            raise ValueError("FaultPlan.choose needs at least one option")
        return options[int(self._rng.integers(len(options)))]

    def raise_fault(self, site: str) -> None:
        raise FaultError(f"injected fault: {site} (seed={self.seed})")

    # -- harness-facing API -------------------------------------------------
    def pending(self) -> List[Fault]:
        return list(self._pending)

    def exhausted(self) -> bool:
        """True once every scheduled fault has fired — the matrix harness
        requires this, so a plan cannot 'pass' by never being applicable."""
        return not self._pending


def corrupt_snapshot(directory: str, mode: str = "truncate",
                     seed: int = 0) -> str:
    """Damage the newest snapshot under ``directory`` in place.

    ``mode="truncate"`` cuts ``arrays.npz`` to half its bytes (a crash
    mid-``rename`` cannot produce this — the atomic write-temp-then-rename
    protocol only exposes whole files — but a torn disk or a partial copy
    can); ``mode="garbage"`` overwrites a seeded byte range in the middle.
    Returns the path of the damaged file.  Restore must answer with a
    readable :class:`ValueError`, never a half-restore.
    """
    steps = sorted(n for n in os.listdir(directory)
                   if n.startswith("step_"))
    if not steps:
        raise ValueError(f"no snapshot steps under {directory!r}")
    path = os.path.join(directory, steps[-1], "arrays.npz")
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
    elif mode == "garbage":
        rng = np.random.default_rng(seed)
        junk = rng.integers(0, 256, size=max(size // 4, 16),
                            dtype=np.uint8).tobytes()
        with open(path, "r+b") as f:
            f.seek(size // 3)
            f.write(junk)
    else:
        raise ValueError(f"unknown corruption mode {mode!r} "
                         "(want 'truncate' or 'garbage')")
    return path
