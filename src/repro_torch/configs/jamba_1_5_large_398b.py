"""Jamba-1.5-Large 398B [arXiv:2403.19887; hf] — Mamba+attention 1:7
interleave (attention at layer i%8==4), MoE 16e top-2 every other layer."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv=8, d_ff=24576,
    vocab=65536, head_dim=128, rope_theta=1e4,
    n_experts=16, top_k=2, moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=4, d_state=16, d_conv=4, ssm_expand=2,
    fsdp=True,
)
