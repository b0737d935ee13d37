"""seamless-m4t-medium — encoder-decoder multimodal backbone.
[arXiv:2308.11596; hf]  12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
The speech frontend is a STUB per contract: input_specs() provides
precomputed frame embeddings (frontend_dim=1024); we model 12 encoder +
12 decoder layers (the transformer backbone)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    vocab=256_206,
    d_model=1_024,
    n_layers=12,  # decoder
    enc_layers=12,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4_096,
    blocks=(("encdec", 12),),
    activation="gelu",
    frontend_dim=1_024,
    rope_theta=1e4,
    source="arXiv:2308.11596; hf",
)
