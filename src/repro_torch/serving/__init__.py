"""Continuous-batching serving: pool, scheduler, sampler, engine."""
from .cache_pool import BlockAllocator, CachePool
from .engine import ContinuousEngine
from .sampling import RequestOutput, SamplingParams
from .scheduler import PrefixTrie, block_hashes

__all__ = ["BlockAllocator", "CachePool", "ContinuousEngine", "PrefixTrie",
           "RequestOutput", "SamplingParams", "block_hashes"]
