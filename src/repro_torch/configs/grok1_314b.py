"""grok-1-314b — 8-expert top-2 MoE. [hf:xai-org/grok-1; unverified]
64L d_model=6144 48H (kv=8) d_ff=32768 vocab=131072."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    vocab=131_072,
    d_model=6_144,
    n_layers=64,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32_768,
    blocks=(("moe", 64),),
    n_experts=8,
    top_k=2,
    activation="silu",  # gated experts (GeGLU in the original; SwiGLU here —
                        # identical parameter/FLOP structure): 3x (6144x32768)
                        # per expert => ~316B total, matching the 314B class
    rope_theta=1e4,
    fsdp=True,
    source="hf:xai-org/grok-1; unverified",
)
