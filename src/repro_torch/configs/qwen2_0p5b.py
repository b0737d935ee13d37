"""qwen2-0.5b — GQA with QKV bias. [arXiv:2407.10671; hf]
24L d_model=896 14H (kv=2) d_ff=4864 vocab=151936, tied embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    vocab=151_936,
    d_model=896,
    n_layers=24,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4_864,
    blocks=(("dense", 24),),
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    parallelism="dp",  # 0.5B: pure DP; 14 heads don't divide a 16-way TP axis
    source="arXiv:2407.10671; hf",
)
