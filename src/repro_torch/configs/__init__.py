"""Architecture configuration (twin of ``repro.configs``).

``pdtype`` / ``cdtype`` return torch dtypes.  Only the architectures the
port serves so far are registered; the rest raise a ``KeyError`` that says
so.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | encdec | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1
    moe_offset: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # --- hybrid / ssm ---
    attn_every: int = 0
    attn_offset: int = 0
    d_state: int = 16
    d_conv: int = 4
    ssm_expand: int = 2
    rwkv_head_dim: int = 64
    # --- encoder-decoder ---
    enc_layers: int = 0
    # --- multimodal stub frontend ---
    frontend: str = ""
    frontend_tokens: int = 0
    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # --- the paper's technique ---
    sparsity: float = 0.5
    sparse_policy: str = "balanced"
    kv_k_sparsity: float = 0.3
    kv_v_sparsity: float = 0.5
    kv_tail: int = 128
    # --- distribution / memory knobs (kept for field parity) ---
    cp_decode: bool = False
    ep_moe: bool = False
    serve_fsdp: bool = True
    full_attn_max: int = 4096
    tp_pad: int = 16
    remat: bool = True
    scan_layers: bool = True
    attn_impl: str = "masked"
    seq_shard: bool = True
    fsdp: bool = False
    zero1: bool = True
    scan_chunk: int = 128

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def padded_heads(self) -> int:
        if self.n_heads == 0:
            return 0
        p = self.tp_pad
        return -(-self.n_heads // p) * p

    def is_moe_layer(self, i: int) -> bool:
        return (self.n_experts > 0) and (i % self.moe_every == self.moe_offset)

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return i % self.attn_every == self.attn_offset
        return True

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def reduced(self) -> "ArchConfig":
        """Family-preserving tiny variant for CPU tests (same rule as the
        reference, so both packages build identical shapes)."""
        kw = dict(
            n_layers=4, d_model=128, n_heads=4, n_kv=min(self.n_kv, 2) or 0,
            d_ff=256, vocab=512, head_dim=32, tp_pad=1, seq_shard=False,
            fsdp=False, scan_chunk=16,
        )
        if self.n_experts:
            kw.update(n_experts=4, top_k=min(self.top_k, 2),
                      moe_every=min(self.moe_every, 2),
                      moe_offset=self.moe_offset % min(self.moe_every, 2))
        if self.family == "hybrid":
            kw.update(attn_every=2, attn_offset=1, ssm_expand=2, d_state=4,
                      n_layers=4)
        if self.family == "ssm":
            kw.update(rwkv_head_dim=32, n_heads=4)
        if self.enc_layers:
            kw.update(enc_layers=2, n_layers=2)
        if self.frontend:
            kw.update(frontend_tokens=8)
        return dataclasses.replace(self, **kw)


_MODULES = {
    "qwen3-0.6b": "qwen3_0_6b",
}


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"architecture {name!r} is not ported to repro_torch "
                       f"yet (ported: {sorted(_MODULES)})")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
