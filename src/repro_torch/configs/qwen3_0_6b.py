"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family; hf] — qk_norm, GQA, head_dim 128."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv=8, d_ff=3072,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
    tie_embeddings=True,
)
