"""Deterministic synthetic prompts (numpy only; a copy of the generator in
``repro.data.pipeline``, so both packages draw the same tokens from the same
seed).  Each example is a Zipf-distributed unigram mixture with repeated
motifs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 8
    motif_count: int = 64


def _example_tokens(dc: DataConfig, step: int, idx: np.ndarray) -> np.ndarray:
    """Deterministic [len(idx), seq_len+1] int32 tokens."""
    rngs = [np.random.default_rng(
        np.random.SeedSequence([dc.seed, step, int(i)])) for i in idx]
    out = np.empty((len(idx), dc.seq_len + 1), np.int32)
    motif_rng = np.random.default_rng(np.random.SeedSequence([dc.seed, 7]))
    motifs = motif_rng.integers(0, dc.vocab,
                                (dc.motif_count, dc.motif_len), np.int64)
    for r, rng in enumerate(rngs):
        # zipf-ish unigram mixture
        z = rng.zipf(1.3, dc.seq_len + 1).astype(np.int64)
        toks = (z - 1) % dc.vocab
        # overwrite random spans with repeated motifs (learnable bigrams)
        n_spans = (dc.seq_len + 1) // (dc.motif_len * 4)
        for _ in range(max(n_spans, 1)):
            m = motifs[rng.integers(0, dc.motif_count)]
            pos = rng.integers(0, dc.seq_len + 1 - dc.motif_len)
            toks[pos:pos + dc.motif_len] = m
        out[r] = toks.astype(np.int32)
    return out


def host_batch(dc: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Full global batch on one host (tests / single-process runs)."""
    idx = np.arange(dc.global_batch)
    toks = _example_tokens(dc, step, idx)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": np.ones((dc.global_batch, dc.seq_len), np.float32)}
