"""Continuous-batching serving: pool, scheduler, sampler, engine."""
from .engine import ContinuousEngine
from .sampling import RequestOutput, SamplingParams

__all__ = ["ContinuousEngine", "RequestOutput", "SamplingParams"]
