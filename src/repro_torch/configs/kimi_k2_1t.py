"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8.
[arXiv:2501.kimi2; unverified]  61L d_model=7168 64H (kv=8) d_ff=2048
(per expert) vocab=163840."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    vocab=163_840,
    d_model=7_168,
    n_layers=61,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2_048,
    blocks=(("moe", 61),),
    n_experts=384,
    top_k=8,
    rope_theta=5e5,
    fsdp=True,
    source="arXiv:2501.kimi2; unverified",
)
