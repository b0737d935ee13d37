"""xlstm-125m — sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]
12L d_model=768 4H d_ff=0 (no separate FFN — xLSTM blocks carry their own
projections) vocab=50304.  Pattern: 3 mLSTM then 1 sLSTM, repeated (the
xLSTM paper's mixed [m:s] ratio)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    vocab=50_304,
    d_model=768,
    n_layers=12,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    blocks=(("mlstm", 3), ("slstm", 1), ("mlstm", 3), ("slstm", 1),
            ("mlstm", 3), ("slstm", 1)),
    tie_embeddings=True,
    sub_quadratic=True,
    parallelism="dp",  # 125M: pure DP is the right large-scale profile
    source="arXiv:2405.04517; unverified",
)
