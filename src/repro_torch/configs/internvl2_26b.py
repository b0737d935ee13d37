"""internvl2-26b — InternViT frontend (STUB per contract) + InternLM2-20B
backbone. [arXiv:2404.16821; hf]  48L d_model=6144 48H (kv=8) d_ff=16384
vocab=92553.  input_specs() provides precomputed patch embeddings
(frontend_dim=3200, InternViT-6B hidden size); a learned projector maps
them into the LM embedding space as a prefix."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    vocab=92_553,
    d_model=6_144,
    n_layers=48,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    blocks=(("dense", 48),),
    frontend_dim=3_200,
    frontend_tokens=1_024,  # image patch tokens prefixed to the text sequence
    rope_theta=1e6,
    fsdp=True,
    source="arXiv:2404.16821; hf",
)
