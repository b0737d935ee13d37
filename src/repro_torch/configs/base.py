"""ArchConfig: one declarative record per assigned architecture.

Every config is constructible at full scale (dry-run via ShapeDtypeStruct —
no allocation) and at reduced "smoke" scale (real CPU forward/train step).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    blocks: Tuple[Tuple[str, int], ...]  # homogeneous segments (kind, count)
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 5e5
    activation: str = "silu"
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_groups: int = 16  # routing groups == DP shard count at scale
    moe_capacity_factor: float = 1.25  # >= top_k*E/T for drop-free serving
    # SSM / hybrid
    ssm_state: int = 0
    ssm_chunk: int = 128  # SSD chunk length (perf knob)
    shared_attn_every: int = 0  # Zamba-style tied shared block cadence
    # Encoder-decoder
    enc_layers: int = 0
    # Modality frontend (stub per contract): precomputed embedding dim
    frontend_dim: int = 0
    frontend_tokens: int = 0  # prefix length contributed by the frontend
    tie_embeddings: bool = False
    sub_quadratic: bool = False  # can run long_500k
    fsdp: bool = False  # additionally shard params over the data axis
    parallelism: str = "tp"  # "tp" | "dp" (see parallel.sharding.make_rules)
    remat_policy: str = "full"  # "full" | "dots" | "none" (perf knob)
    attn_chunk_threshold: int = 2048  # online-softmax attention beyond this
    # Per-projection quantization policy for every block projection
    # (qkv/out/up/gate/down and MoE expert GEMMs; router, embeddings and
    # lm_head stay full precision).  A core/precision.py registry name:
    # "none" (no declaration — an ambient use_precision() context still
    # applies) | "f32" (force full precision) | "bf16" | "int8" (weights
    # int8 per-tile, activations bf16) | "int8_all" | "int8_tensor" |
    # "fp8" | "fp8_all".
    precision: str = "none"
    source: str = ""

    @property
    def model_kind(self) -> str:
        return "encdec" if self.enc_layers else "decoder"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    # ------------- parameter accounting (for MODEL_FLOPS) -------------

    def _block_params(self, kind: str) -> int:
        d, ff = self.d_model, self.d_ff
        attn = d * self.n_heads * self.hd * 2 + d * self.n_kv_heads * self.hd * 2
        if kind == "dense":
            mlp = 3 * d * ff if self.activation == "silu" else 2 * d * ff
            return attn + mlp
        if kind == "moe":
            nmat = 3 if self.activation == "silu" else 2
            return attn + d * self.n_experts + self.n_experts * nmat * d * ff
        if kind == "encdec":
            mlp = 3 * d * ff if self.activation == "silu" else 2 * d * ff
            xattn = attn  # cross-attention second set
            return attn + xattn + mlp
        if kind == "mamba2":
            di = 2 * d
            s = self.ssm_state
            h = di // 64
            return d * (2 * di + 2 * s + h) + di * d
        if kind == "mlstm":
            di = 2 * d
            return d * 2 * di + 3 * di * di + di * d
        if kind == "slstm":
            hd = d // self.n_heads
            return d * 4 * d + self.n_heads * hd * 4 * hd + d * d
        raise ValueError(kind)

    def _moe_active_block_params(self) -> int:
        d, ff = self.d_model, self.d_ff
        attn = d * self.n_heads * self.hd * 2 + d * self.n_kv_heads * self.hd * 2
        nmat = 3 if self.activation == "silu" else 2
        return attn + d * self.n_experts + self.top_k * nmat * d * ff

    def n_params(self) -> int:
        total = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        for kind, n in self.blocks:
            total += n * self._block_params(kind)
        if self.shared_attn_every:
            mlp_ff = self.d_ff or 4 * self.d_model
            d = self.d_model
            attn = d * self.n_heads * self.hd * 2 + d * self.n_kv_heads * self.hd * 2
            total += attn + 3 * d * mlp_ff
        if self.enc_layers:
            d, ff = self.d_model, self.d_ff
            attn = d * self.n_heads * self.hd * 2 + d * self.n_kv_heads * self.hd * 2
            mlp = 3 * d * ff if self.activation == "silu" else 2 * d * ff
            total += self.enc_layers * (attn + mlp)
        if self.frontend_dim:
            total += self.frontend_dim * self.d_model
        return total

    def n_active_params(self) -> int:
        """Per-token active parameters (== n_params for non-MoE)."""
        if not self.n_experts:
            return self.n_params()
        total = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        for kind, n in self.blocks:
            if kind == "moe":
                total += n * self._moe_active_block_params()
            else:
                total += n * self._block_params(kind)
        return total

    # ------------- reduced smoke config -------------

    def smoke(self) -> "ArchConfig":
        """Same family/topology, tiny dimensions — one CPU train step."""
        scale = {}
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        blocks = []
        for kind, n in self.blocks:
            blocks.append((kind, min(n, 4 if self.shared_attn_every else 2)))
        shared_every = 2 if self.shared_attn_every else 0
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            vocab=256,
            d_model=64,
            n_layers=sum(n for _, n in blocks),
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=16,
            d_ff=128,
            blocks=tuple(blocks),
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_groups=1,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            shared_attn_every=shared_every,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            frontend_dim=32 if self.frontend_dim else 0,
            frontend_tokens=8 if self.frontend_tokens else 0,
            fsdp=False,
        )
