"""zamba2-2.7b — hybrid Mamba2 backbone + tied shared attention block.
[arXiv:2411.15242; hf]  54L d_model=2560 32H (kv=32) d_ff=10240 (shared
block MLP) vocab=32000 ssm_state=64.  The shared transformer block is a
single weight-tied block applied every 6 Mamba2 layers (Zamba2's
shared-block mechanism; we use one shared block, the paper alternates two —
noted simplification)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    vocab=32_000,
    d_model=2_560,
    n_layers=54,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10_240,
    blocks=(("mamba2", 54),),
    ssm_state=64,
    shared_attn_every=6,
    rope_theta=1e4,
    tie_embeddings=True,
    sub_quadratic=True,
    source="arXiv:2411.15242; hf",
)
