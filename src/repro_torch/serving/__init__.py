"""Continuous-batching serving: pool, scheduler, sampler, engine."""
from .cache_pool import BlockAllocator, CachePool
from .engine import (CapturedEntry, ContinuousEngine, assign_entry,
                     panel_entry, prefill_entry, refreeze_entry,
                     stable_trace_counts)
from .sampling import RequestOutput, SamplingParams
from .scheduler import PrefixTrie, block_hashes
from .spec import AdaptiveDraft, Drafter, NGramDrafter, SpecConfig

__all__ = ["AdaptiveDraft", "BlockAllocator", "CachePool", "CapturedEntry",
           "ContinuousEngine", "Drafter", "NGramDrafter", "PrefixTrie",
           "RequestOutput", "SamplingParams", "SpecConfig", "assign_entry",
           "block_hashes", "panel_entry", "prefill_entry", "refreeze_entry",
           "stable_trace_counts"]
