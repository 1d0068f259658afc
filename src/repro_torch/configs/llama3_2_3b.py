"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-1B family; unverified]."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv=8, d_ff=8192,
    vocab=128256, head_dim=128, rope_theta=5e5,
)
