"""Phi-3.5-MoE-42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct; hf]
16 experts, top-2, every layer."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=6400,
    vocab=32064, head_dim=128, rope_theta=1e4,
    n_experts=16, top_k=2, moe_every=1, fsdp=True,
)
