"""llama3.2-1b — small llama3. [hf:meta-llama/Llama-3.2-1B; unverified]
16L d_model=2048 32H (kv=8) d_ff=8192 vocab=128256, tied embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    vocab=128_256,
    d_model=2_048,
    n_layers=16,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8_192,
    blocks=(("dense", 16),),
    rope_theta=5e5,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B; unverified",
)
