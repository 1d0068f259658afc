"""RWKV-6 (Finch) 7B [arXiv:2404.05892; hf] — attention-free,
data-dependent decay; 64 heads of 64."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv=0, d_ff=14336,
    vocab=65536, rwkv_head_dim=64,
)
