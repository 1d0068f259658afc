"""Continuous-batching serving: pool, scheduler, sampler, engine, the
fault plan and the HTTP frontend."""
from .cache_pool import BlockAllocator, CachePool
from .engine import (CapturedEntry, ContinuousEngine, Engine, assign_entry,
                     panel_entry, prefill_entry, refreeze_entry,
                     release_entry, set_lane_entry, stable_trace_counts)
from .faults import Fault, FaultError, FaultPlan, corrupt_snapshot
from .frontend import EngineLoop, ServerFrontend, params_from_json
from .sampling import RequestOutput, SamplingParams
from .scheduler import PrefixTrie, Scheduler, block_hashes
from .spec import AdaptiveDraft, Drafter, NGramDrafter, SpecConfig

__all__ = ["AdaptiveDraft", "BlockAllocator", "CachePool", "CapturedEntry",
           "ContinuousEngine", "Drafter", "Engine", "EngineLoop", "Fault",
           "FaultError", "FaultPlan", "NGramDrafter", "PrefixTrie",
           "RequestOutput", "SamplingParams", "Scheduler",
           "ServerFrontend", "SpecConfig", "assign_entry", "block_hashes",
           "corrupt_snapshot", "panel_entry", "params_from_json",
           "prefill_entry", "refreeze_entry", "release_entry",
           "set_lane_entry", "stable_trace_counts"]
