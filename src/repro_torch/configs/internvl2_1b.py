"""InternVL2-1B [arXiv:2404.16821; hf] — InternViT frontend (stub) +
InternLM2-ish 0.5B LM backbone."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv=2, d_ff=4864,
    vocab=151655, head_dim=64, rope_theta=1e6,
    frontend="patch", frontend_tokens=256, tie_embeddings=True,
)
