"""Mamba-2 (SSD) block (port of `repro/models/ssm.py`).

The chunked SSD runs as `ssd_chunked`: on the CUDA backends one launch of
the `ssd_scan` kernel for every (sequence, head), b and c read per group
(JAX's model computes the same scan in jnp, its Pallas kernel takes one
head); on the "torch" backend the plain chunked einsum form.  The
recurrent `decode` step is plain PyTorch on every backend, as in JAX.
`in_proj` / `out_proj` ride the MX dispatch (`core.ops.matmul`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core import ops
from ..kernels.ref import ssd_scan_plain
from ..kernels.ssd_scan import ssd_scan
from .layers import rms_norm
from .modules import Builder, Module


def ssd_chunked(x, a_log, b, c, chunk: int = 128):
    """Batched chunked SSD.  x: (B, L, H, P) per-head inputs (already
    dt-scaled); a_log: (B, L, H) f32 log decay per step; b, c: (B, L, G, S)
    with G dividing H (JAX takes them repeated to H heads; G = H is that
    case).  Returns y (B, L, H, P) in x's dtype."""
    if ops.current_policy().resolve(x) == "torch":
        return ssd_scan_plain(x, a_log, b, c, chunk)
    return ssd_scan(x.contiguous(), a_log.contiguous(), b.contiguous(), c.contiguous(),
                    chunk=chunk)


@dataclasses.dataclass(frozen=True)
class Mamba2Block(Module):
    d_model: int
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    def build(self, mk: Builder):
        di, g, s, h = self.d_inner, self.n_groups, self.d_state, self.n_heads
        d_in_proj = 2 * di + 2 * g * s + h  # z, x, B, C, dt
        return {
            "ln": mk.param("ln", (self.d_model,), init="ones"),
            "in_proj": mk.param("in_proj", (self.d_model, d_in_proj)),
            "conv_w": mk.param("conv_w", (self.d_conv, self.conv_channels), scale=0.5),
            "conv_b": mk.param("conv_b", (self.conv_channels,), init="zeros"),
            "a_log": mk.param("a_log", (h,), init="zeros"),
            "dt_bias": mk.param("dt_bias", (h,), init="zeros"),
            "d_skip": mk.param("d_skip", (h,), init="ones"),
            "norm_w": mk.param("norm_w", (di,), init="ones"),
            "out_proj": mk.param("out_proj", (di, self.d_model)),
        }

    def _split(self, zxbcdt):
        di = self.d_inner
        z = zxbcdt[..., :di]
        xbc = zxbcdt[..., di:di + self.conv_channels]
        dt = zxbcdt[..., di + self.conv_channels:]
        return z, xbc, dt

    def _conv(self, p, xbc):
        """Depthwise causal conv1d over (B, L, C), then silu."""
        w = p["conv_w"].to(xbc.dtype)  # (K, C)
        K, L = self.d_conv, xbc.shape[1]
        pad = F.pad(xbc, (0, 0, K - 1, 0))
        out = pad[:, 0:L] * w[0]
        for i in range(1, K):
            out = out + pad[:, i:i + L] * w[i]
        return F.silu(out + p["conv_b"].to(xbc.dtype))

    def _ssm_inputs(self, p, xbc_conv, dt):
        """(xs (B, L, H, P), softplus dt (B, L, H) f32, a_log per step (B, L,
        H) f32, b and c (B, L, G, S)).  b and c stay per group: JAX repeats
        them to H heads, the kernel and the plain scan read group
        h // (H / G) instead."""
        di, g, s, h = self.d_inner, self.n_groups, self.d_state, self.n_heads
        B_, L = xbc_conv.shape[0], xbc_conv.shape[1]
        xs = xbc_conv[..., :di].reshape(B_, L, h, self.head_dim)
        b = xbc_conv[..., di:di + g * s].reshape(B_, L, g, s)
        c = xbc_conv[..., di + g * s:].reshape(B_, L, g, s)
        dt = F.softplus(dt.float() + p["dt_bias"].float())
        a = -torch.exp(p["a_log"].float())  # (h,) < 0
        return xs, dt, a * dt, b, c

    def __call__(self, p, x):
        """x: (B, L, D) -> (B, L, D).  Pre-norm residual block (chunked SSD)."""
        B_, L, _ = x.shape
        res = x
        x = rms_norm(x, p["ln"])
        zxbcdt = ops.matmul(x, p["in_proj"], out_dtype=x.dtype)
        z, xbc, dt = self._split(zxbcdt)
        xbc = self._conv(p, xbc)
        xs, dt_act, a_log, b, c = self._ssm_inputs(p, xbc, dt)
        x_in = xs * dt_act[..., None].to(xs.dtype)
        y = ssd_chunked(x_in, a_log, b, c, chunk=self.chunk)
        y = y + xs * p["d_skip"].to(xs.dtype)[None, None, :, None]
        y = y.reshape(B_, L, self.d_inner)
        y = rms_norm(y * F.silu(z), p["norm_w"])
        return res + ops.matmul(y, p["out_proj"], out_dtype=x.dtype)

    # ---------------- decode (recurrent) path ----------------

    def init_state(self, batch: int, *, dtype=torch.float32, device="cuda"):
        """The rolling conv window (batch, d_conv-1, channels) and the f32
        SSM state (batch, H, S, P), zeroed."""
        return {
            "conv": torch.zeros((batch, self.d_conv - 1, self.conv_channels), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, self.n_heads, self.d_state, self.head_dim),
                               dtype=torch.float32, device=device),
        }

    def decode(self, p, x, state):
        """One token.  x: (B, 1, D) -> (y, state), the state updated IN
        PLACE (JAX returns a new one).  Plain PyTorch on every backend
        apart from the two projections."""
        B_ = x.shape[0]
        res = x
        x = rms_norm(x, p["ln"])
        zxbcdt = ops.matmul(x, p["in_proj"], out_dtype=x.dtype)
        z, xbc, dt = self._split(zxbcdt)
        conv_in = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)  # rolling window
        w = p["conv_w"].to(xbc.dtype)
        out = conv_in[:, 0:1] * w[0]
        for i in range(1, self.d_conv):
            out = out + conv_in[:, i:i + 1] * w[i]
        xbc_conv = F.silu(out + p["conv_b"].to(xbc.dtype))
        xs, dt_act, a_log, b, c = self._ssm_inputs(p, xbc_conv, dt)
        rep = self.n_heads // self.n_groups
        b = b.repeat_interleave(rep, dim=2)  # (B, 1, H, S), as JAX repeats
        c = c.repeat_interleave(rep, dim=2)
        # h = exp(a_log) h + b^T (dt x)
        a = torch.exp(a_log[:, 0, :])  # (B, H)
        x_in = (xs * dt_act[..., None].to(xs.dtype))[:, 0]  # (B, H, P)
        h = state["ssm"] * a[..., None, None] + torch.einsum(
            "bhs,bhp->bhsp", b[:, 0].float(), x_in.float())
        y = torch.einsum("bhs,bhsp->bhp", c[:, 0].float(), h)
        y = y.to(xs.dtype) + xs[:, 0] * p["d_skip"].to(xs.dtype)[None, :, None]
        y = y.reshape(B_, 1, self.d_inner)
        y = rms_norm(y * F.silu(z), p["norm_w"])
        out = res + ops.matmul(y, p["out_proj"], out_dtype=x.dtype)
        state["conv"].copy_(conv_in[:, 1:])
        state["ssm"].copy_(h)
        return out, state
