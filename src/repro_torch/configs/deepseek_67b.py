"""DeepSeek-67B [arXiv:2401.02954; hf] — llama-arch dense, GQA kv=8."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv=8, d_ff=22016,
    vocab=102400, head_dim=128, rope_theta=1e4, fsdp=True,
)
