"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
MoE 16 experts top-1 + shared expert, every layer; early-fusion multimodal
(text-only backbone here; fusion enters as embedding inputs)."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=8192,
    vocab=202048, head_dim=128, rope_theta=5e5,
    n_experts=16, top_k=1, moe_every=1, shared_expert=True, fsdp=True,
)
