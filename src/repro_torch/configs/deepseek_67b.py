"""deepseek-67b — dense llama-arch. [arXiv:2401.02954; hf]
95L d_model=8192 64H (kv=8) d_ff=22016 vocab=102400."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    vocab=102_400,
    d_model=8_192,
    n_layers=95,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22_016,
    blocks=(("dense", 95),),
    rope_theta=1e4,
    fsdp=True,
    source="arXiv:2401.02954; hf",
)
