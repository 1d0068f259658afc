"""Architecture and shape configuration (twin of ``repro.configs``).

Each registered architecture has a ``<id>.py`` here exporting ``CONFIG``.
``pdtype`` / ``cdtype`` return torch dtypes.  Every id of the reference
is registered: the dense family, the VLM (a dense backbone behind a stub
frontend), the MoE family (Phi-3.5-MoE, Llama-4-Scout), RWKV-6 (ssm),
Jamba (hybrid: Mamba and attention) and SeamlessM4T (encoder-decoder).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


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
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

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


ARCH_IDS = [
    "qwen3-0.6b", "deepseek-67b", "llama3.2-3b", "phi3-mini-3.8b",
    "llama4-scout-17b-a16e", "phi3.5-moe-42b-a6.6b", "seamless-m4t-medium",
    "internvl2-1b", "rwkv6-7b", "jamba-1.5-large-398b",
]
PAPER_ARCH = "llama3-8b"          # the paper's own evaluation model

_MODULES = {
    "qwen3-0.6b": "qwen3_0_6b",
    "deepseek-67b": "deepseek_67b",
    "llama3.2-3b": "llama3_2_3b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "internvl2-1b": "internvl2_1b",
    "llama3-8b": "llama3_8b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "rwkv6-7b": "rwkv6_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r} (registered: "
                       f"{sorted(_MODULES)})")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def applicable_shapes(cfg: ArchConfig) -> Tuple[str, ...]:
    """long_500k needs sub-quadratic attention: SSM/hybrid only."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in ("ssm", "hybrid"):
        out.append("long_500k")
    return tuple(out)
