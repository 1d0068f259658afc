"""Llama-3-8B — the paper's own evaluation model (Figs 1,3,11,12; Table 2)."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=128256, head_dim=128, rope_theta=5e5,
)
