"""SeamlessM4T-medium [arXiv:2308.11596; hf] — encoder-decoder, multimodal.
12 encoder + 12 decoder layers; speech frontend is a stub (input_specs
yields precomputed frame embeddings)."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, enc_layers=12, d_model=1024, n_heads=16, n_kv=16,
    d_ff=4096, vocab=256206, head_dim=64, rope_theta=1e4,
    # the speech frontend stub is the encoder src_embeds input itself
)
