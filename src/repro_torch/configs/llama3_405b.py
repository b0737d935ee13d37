"""llama3-405b — dense GQA flagship. [arXiv:2407.21783; unverified]
126L d_model=16384 128H (kv=8) d_ff=53248 vocab=128256."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    vocab=128_256,
    d_model=16_384,
    n_layers=126,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53_248,
    blocks=(("dense", 126),),
    rope_theta=5e5,
    fsdp=True,
    source="arXiv:2407.21783; unverified",
)
