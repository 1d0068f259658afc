"""Phi-3-mini-3.8B [arXiv:2404.14219; unverified] — RoPE SwiGLU, MHA (kv=32)."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv=32, d_ff=8192,
    vocab=32064, head_dim=96, rope_theta=1e4,
)
