"""Mixture-of-Experts layer with grouped, sort-based capacity dispatch (port
of `repro/models/moe.py`).

Tokens split into G routing groups (G = n_groups when it divides the token
count, else 1); within a group: router top-k, a stable sort of the
(token, choice) pairs by expert, capacity C per expert per group, and
entries past C dropped -- the JAX semantics, kept exactly, since with drops
any difference in order changes the output.

The dispatch buffer is laid out expert-major, (E, G*C, D): expert e's rows
of every group are contiguous, so on the CUDA backends each projection is
ONE `ops.grouped_matmul` launch that streams each expert's weights once.
JAX launches per routing group over (E*C, D) rows, so a 64-token grok
chunk (G = 16) would stream every expert 16 times; each output row depends
only on its own input row and expert, so both layouts compute the same
function.  The "torch" backend runs the batched einsum of the JAX "xla"
path, with h cast to the buffer dtype between the two GEMMs.

A declared or ambient precision (`precision`, `use_precision`) routes every
backend through `ops.grouped_matmul`, as in JAX: the CUDA backends through
the grouped kernel's scale slots, "torch" through its quantized reference.
The weights quantize per expert and per column, the activations per row,
both independent of the buffer's layout; a "tensor"-granularity activation
scale is the one exception -- JAX takes one amax per routing group (one
call per group), so the expert-major launch takes one per group too
(`a_row_groups`), for the up / gate input and again for h.  The router
stays full precision on every backend.

Combine: expert outputs are gathered back into (token, choice) order,
weighted by the renormalized gates and summed over the k choices in choice
order, in f32 (JAX's scatter-add sums them in expert order; for top-2 the
two orders agree to the bit).

Under an active `parallel.sharding.collective_policy` whose ring divides
the expert rows (R = G*C) and d_ff, the collective branch takes precedence
over the grouped launch, as in JAX: per-expert `ops.linear` calls, the
up (and gate) projection a ring all-gather x matmul with d_ff sharded over
the ring, the down projection a ring matmul x reduce-scatter.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..core import ops
from ..kernels.mx_matmul import dot_f32
from ..parallel.sharding import current_collectives
from .modules import Builder, Module


@dataclasses.dataclass(frozen=True)
class MoE(Module):
    d_model: int
    d_ff: int  # per-expert hidden size
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    activation: str = "silu"  # "silu" => gated experts (SwiGLU); else gelu
    n_groups: int = 1
    precision: Optional[str] = None

    @property
    def gated(self) -> bool:
        return self.activation == "silu"

    def build(self, mk: Builder):
        E, D, Fd = self.n_experts, self.d_model, self.d_ff
        p = {
            "router": mk.param("router", (D, E), ("embed", "expert"), scale=0.02),
            "wi": mk.param("wi", (E, D, Fd), ("expert", "embed", "mlp")),
            "wo": mk.param("wo", (E, Fd, D), ("expert", "mlp", "embed")),
        }
        if self.gated:
            p["wg"] = mk.param("wg", (E, D, Fd), ("expert", "embed", "mlp"))
        return p

    def capacity(self, tokens_per_group: int) -> int:
        per = tokens_per_group * self.top_k / self.n_experts * self.capacity_factor
        return max(8, int(-(-per // 8) * 8))  # round up to 8

    def router_probs(self, p, xg: torch.Tensor) -> torch.Tensor:
        """(G, Tg, D) -> (G, Tg, E) f32 router probabilities.  Plain torch on
        every backend: the router stays off the MX dispatch, as in JAX."""
        logits = dot_f32(xg, p["router"].to(xg.dtype))
        return torch.softmax(logits, dim=-1)

    def _expert_ffn(self, p, xe: torch.Tensor, n_groups: int = 1) -> torch.Tensor:
        """Every expert GEMM over the expert-major buffer xe: (E, R, D),
        R = n_groups * C rows per expert (routing group g's rows at
        [g*C, (g+1)*C) of each expert)."""
        E, R, D = xe.shape
        policy = ops.current_policy()
        prec = ops._ambient_precision(self.precision)
        wi, wo = p["wi"].to(xe.dtype), p["wo"].to(xe.dtype)
        wg = p["wg"].to(xe.dtype) if self.gated else None
        coll = current_collectives()
        if coll is not None and coll.axis_size > 1 and R % coll.axis_size == 0 \
                and self.d_ff % coll.axis_size == 0:
            # JAX's collective branch: one ring pair per expert (only when
            # the chunks divide; otherwise every expert would fall back to a
            # single-device linear, worse than the grouped launch below)
            outs = []
            for e in range(E):
                if self.gated:
                    h = ops.linear(xe[e], wi[e], w_gate=wg[e], activation="swiglu",
                                   policy=policy, tp_mode="allgather",
                                   precision=self.precision)
                else:
                    h = ops.linear(xe[e], wi[e], activation="gelu", policy=policy,
                                   tp_mode="allgather", precision=self.precision)
                outs.append(ops.linear(h, wo[e], policy=policy, tp_mode="reduce_scatter",
                                       precision=self.precision))
            return torch.stack(outs)
        if policy.resolve(xe) == "torch" and prec is None:
            h = dot_f32(xe, wi).to(xe.dtype)
            if self.gated:
                h = F.silu(dot_f32(xe, wg).to(xe.dtype)) * h
            else:
                h = F.gelu(h, approximate="tanh")
            return dot_f32(h, wo).to(h.dtype)
        sizes = torch.full((E,), R, dtype=torch.int32, device=xe.device)
        kw = dict(policy=policy, precision=prec,
                  a_row_groups=(E, n_groups, R // n_groups) if n_groups > 1 else None)
        x2 = xe.reshape(E * R, D)
        if self.gated:
            h = ops.grouped_matmul(x2, wi, sizes, activation="swiglu", w_gate=wg, **kw)
        else:
            h = ops.grouped_matmul(x2, wi, sizes, activation="gelu", **kw)
        return ops.grouped_matmul(h, wo, sizes, **kw).reshape(E, R, D)

    def __call__(self, p, x: torch.Tensor, *, aux_loss_weight: float = 0.01):
        """x: (B, S, D) -> (y, aux_loss)."""
        B, S, D = x.shape
        T = B * S
        G = self.n_groups if T % self.n_groups == 0 else 1
        Tg = T // G
        E, K = self.n_experts, self.top_k
        C = self.capacity(Tg)
        dev = x.device
        xg = x.reshape(G, Tg, D)

        probs = self.router_probs(p, xg)
        # jax.lax.top_k breaks ties by the lower index; a stable descending
        # sort keeps equal probabilities in index order
        top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate_vals, expert_ids = top_p[..., :K], top_i[..., :K]  # (G, Tg, K)
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

        # load-balancing auxiliary loss (Switch-style, per group)
        me = probs.mean(dim=1)  # (G, E)
        counts = F.one_hot(expert_ids, E).sum(dim=(1, 2))  # (G, E)
        ce = counts.float() / (Tg * K)
        aux = aux_loss_weight * E * torch.mean(torch.sum(me * ce, dim=-1))

        # group-local sort-based dispatch: entry j of a group is choice
        # j % K of token j // K
        flat_expert = expert_ids.reshape(G, Tg * K)
        order = torch.argsort(flat_expert, dim=1, stable=True)
        se = torch.gather(flat_expert, 1, order)
        starts = torch.cumsum(counts, dim=1) - counts  # exclusive prefix
        pos = torch.arange(Tg * K, device=dev)[None] - torch.gather(starts, 1, se)
        gidx = torch.arange(G, device=dev)[:, None]
        rows = E * G * C  # expert-major: expert e, group g, slot pos
        row = torch.where(pos < C, se * (G * C) + gidx * C + pos, rows)  # drop -> spare
        buf = torch.zeros((rows + 1, D), dtype=x.dtype, device=dev)
        buf.index_put_((row.reshape(-1),), xg[gidx, order // K].reshape(-1, D))
        y = self._expert_ffn(p, buf[:rows].view(E, G * C, D), G).reshape(rows, D)

        # combine in (token, choice) order: unsort the rows, gather, weight
        row_tk = torch.empty_like(row).scatter_(1, order, row).reshape(G, Tg, K)
        kept = (row_tk < rows)[..., None]
        out = torch.zeros((G, Tg, D), dtype=torch.float32, device=dev)
        for k in range(K):
            yk = y[row_tk[..., k].clamp(max=rows - 1)].float()
            out = out + torch.where(kept[:, :, k], yk, 0.0) * gate_vals[..., k, None]
        return out.reshape(B, S, D).to(x.dtype), aux
