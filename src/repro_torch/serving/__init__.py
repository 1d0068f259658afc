"""Continuous-batching serving: pool, scheduler, sampler, engine."""
from .cache_pool import BlockAllocator, CachePool
from .engine import ContinuousEngine, PanelGraph, stable_trace_counts
from .sampling import RequestOutput, SamplingParams
from .scheduler import PrefixTrie, block_hashes
from .spec import AdaptiveDraft, Drafter, NGramDrafter, SpecConfig

__all__ = ["AdaptiveDraft", "BlockAllocator", "CachePool",
           "ContinuousEngine", "Drafter", "NGramDrafter", "PanelGraph",
           "PrefixTrie", "RequestOutput", "SamplingParams", "SpecConfig",
           "block_hashes", "stable_trace_counts"]
