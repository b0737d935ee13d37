"""xLSTM blocks (port of `repro/models/xlstm.py`): mLSTM (matrix memory,
chunkwise-parallel over the sequence, recurrent at decode) and sLSTM
(scalar memory, strictly recurrent).

The projections ride the MX dispatch (`core.ops.matmul`: `mx_matmul_fused`
on "cuda_mx", `baseline_matmul` on "cuda_baseline"): mLSTM's `up`, `wq`,
`wk`, `wv` and `down`, sLSTM's `w_in` and `out`.  Everything JAX computes
in jnp stays plain PyTorch on every backend: mLSTM's gate projection `wif`
(a plain `jnp.dot` in JAX), the chunkwise products and the recurrent step,
and the sLSTM cell with its per-head recurrent mixing.  Every state is
f32; the running maxima start at -1e30.  `decode` updates its state IN
PLACE (JAX returns a new one), as `Mamba2Block.decode` does.

Stabilized exponential gating as in the xLSTM paper (Beck et al., 2024):
the running max m guards exp() against overflow, and the chunkwise form
equals the recurrent one (`tests/test_torch_xlstm.py`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core import ops
from .layers import rms_norm
from .modules import Builder, Module

M_INIT = -1e30  # the running maxima's start (exp(M_INIT - m) == 0)


def mlstm_chunkwise(q, k, v, i_pre, f_pre, chunk: int = 128):
    """Chunkwise-parallel stabilized mLSTM.  q, k, v: (B, L, H, D); i_pre,
    f_pre: (B, L, H) gate pre-activations.  Returns (B, L, H, D) in v's
    dtype.

    Per head, with lf = logsigmoid(f), bcum_t = cumsum(lf), w_s = i_s -
    bcum_s and M_t = max(m_prev, cummax_{s<=t} w_s):
      D[t, s] = exp(w_s - M_t) for s <= t (0 above the diagonal, where the
                exponent may overflow: masked with `where`, never by a
                product, since inf * 0 is NaN),
      num_t   = (q k^T / sqrt(d) * D) v + exp(m_prev - M_t) (q @ C_prev),
      den_t   = rowsum(q k^T / sqrt(d) * D) + exp(m_prev - M_t) (q . n_prev),
      y_t     = num_t / max(|den_t|, exp(-(bcum_t + M_t))).
    The (C, n, m) state carries across chunks as in the recurrent form.  A
    ragged last chunk is padded with i_pre = -1e9 and f_pre = 0 (JAX's
    padding), which leaves the live rows as they are."""
    B, L, H, D = q.shape
    pad = (-L) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_pre = F.pad(i_pre, (0, 0, 0, pad), value=-1e9)
        f_pre = F.pad(f_pre, (0, 0, 0, pad))
    qf, kf, vf, i_f, f_f = (t.float() for t in (q, k, v, i_pre, f_pre))
    scale = 1.0 / (D**0.5)
    dev = q.device
    C = torch.zeros((B, H, D, D), device=dev)
    n = torch.zeros((B, H, D), device=dev)
    m_prev = torch.full((B, H), M_INIT, device=dev)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))[None, :, :, None]
    ys = []
    for c0 in range(0, q.shape[1], chunk):
        qq, kk, vv = (t[:, c0:c0 + chunk] for t in (qf, kf, vf))
        lf = F.logsigmoid(f_f[:, c0:c0 + chunk])                       # (B, Q, H)
        bcum = torch.cumsum(lf, dim=1)
        w = i_f[:, c0:c0 + chunk] - bcum
        Mt = torch.maximum(m_prev[:, None, :], torch.cummax(w, dim=1).values)
        dmat = torch.exp(w[:, None, :, :] - Mt[:, :, None, :])         # (B, t, s, H)
        dmat = torch.where(tri, dmat, torch.zeros((), device=dev))
        s_mat = torch.einsum("blhd,bmhd->blmh", qq, kk) * scale * dmat
        num = torch.einsum("blmh,bmhd->blhd", s_mat, vv)
        state_w = torch.exp(m_prev[:, None, :] - Mt)                    # (B, Q, H)
        num = num + state_w[..., None] * torch.einsum("blhd,bhde->blhe", qq * scale, C)
        den = s_mat.sum(dim=2) + state_w * torch.einsum("blhd,bhd->blh", qq * scale, n)
        m_t = bcum + Mt
        ys.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # ---- state update ----
        MQ = Mt[:, -1, :]                                               # (B, H)
        coef = torch.exp(w - MQ[:, None, :])
        decay = torch.exp(m_prev - MQ)
        kc = kk * coef[..., None]
        C = decay[..., None, None] * C + torch.einsum("blhd,blhe->bhde", kc, vv)
        n = decay[..., None] * n + kc.sum(dim=1)
        m_prev = bcum[:, -1, :] + MQ
    y = torch.cat(ys, dim=1)[:, :L]
    return y.to(v.dtype)


def mlstm_recurrent_step(C, n, m, q, k, v, i_pre, f_pre):
    """One stabilized recurrent step (the decode path, and the oracle of the
    chunkwise form).  C: (B, H, D, D), n: (B, H, D), m: (B, H); q, k, v:
    (B, H, D); gates: (B, H).  Returns (C, n, m, y), y in v's dtype."""
    D = q.shape[-1]
    scale = 1.0 / (D**0.5)
    lf = F.logsigmoid(f_pre.float())
    li = i_pre.float()
    m_new = torch.maximum(lf + m, li)
    fp = torch.exp(lf + m - m_new)
    ip = torch.exp(li - m_new)
    k32, v32, q32 = (t.float() for t in (k, v, q))
    C_new = fp[..., None, None] * C + ip[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", k32, v32)
    n_new = fp[..., None] * n + ip[..., None] * k32
    num = torch.einsum("bhd,bhde->bhe", q32 * scale, C_new)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q32 * scale, n_new).abs(),
                        torch.exp(-m_new))
    return C_new, n_new, m_new, (num / den[..., None]).to(v.dtype)


@dataclasses.dataclass(frozen=True)
class MLSTMBlock(Module):
    """mLSTM block: up-projection (x2), mLSTM mixing, gated skip,
    down-projection.  The head dim is proj_factor * d_model / n_heads (384
    at xlstm-125m's full width)."""

    d_model: int
    n_heads: int
    proj_factor: int = 2
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.proj_factor * self.d_model

    @property
    def hd(self) -> int:
        return self.d_inner // self.n_heads

    def build(self, mk: Builder):
        d, di, h = self.d_model, self.d_inner, self.n_heads
        return {
            "ln": mk.param("ln", (d,), ("embed",), init="ones"),
            "up": mk.param("up", (d, 2 * di), ("embed", "mlp")),
            "wq": mk.param("wq", (di, di), ("mlp", "heads")),
            "wk": mk.param("wk", (di, di), ("mlp", "heads")),
            "wv": mk.param("wv", (di, di), ("mlp", "heads")),
            "wif": mk.param("wif", (di, 2 * h), ("mlp", "heads"), scale=0.02),
            "bif": mk.param("bif", (2 * h,), ("heads",), init="zeros"),
            "norm_w": mk.param("norm_w", (di,), ("mlp",), init="ones"),
            "down": mk.param("down", (di, d), ("mlp", "embed")),
        }

    def _up(self, p, x):
        """(xu, z): the two halves of the up-projection of rms_norm(x)."""
        up = ops.matmul(rms_norm(x, p["ln"]), p["up"], out_dtype=x.dtype)
        return up[..., :self.d_inner], up[..., self.d_inner:]

    def _gates_qkv(self, p, xu):
        B, L, _ = xu.shape
        h, hd = self.n_heads, self.hd
        q = ops.matmul(xu, p["wq"], out_dtype=xu.dtype).reshape(B, L, h, hd)
        k = ops.matmul(xu, p["wk"], out_dtype=xu.dtype).reshape(B, L, h, hd)
        v = ops.matmul(xu, p["wv"], out_dtype=xu.dtype).reshape(B, L, h, hd)
        # the gate projection is a plain product in JAX too (jnp.dot)
        if_pre = torch.matmul(xu, p["wif"].to(xu.dtype)) + p["bif"].to(xu.dtype)
        return q, k, v, if_pre[..., :h], if_pre[..., h:] + 3.0  # JAX's f-bias init trick

    def _out(self, p, x, y, z):
        y = rms_norm(y, p["norm_w"]) * F.silu(z)
        return x + ops.matmul(y, p["down"], out_dtype=x.dtype)

    def __call__(self, p, x):
        """x: (B, L, D) -> (B, L, D), the chunkwise form over the sequence."""
        B, L, _ = x.shape
        xu, z = self._up(p, x)
        q, k, v, i_pre, f_pre = self._gates_qkv(p, xu)
        y = mlstm_chunkwise(q, k, v, i_pre, f_pre, chunk=self.chunk)
        return self._out(p, x, y.reshape(B, L, self.d_inner), z)

    def init_state(self, batch: int, *, device="cuda"):
        """C (batch, H, hd, hd), n (batch, H, hd) zeroed and m (batch, H) at
        -1e30, all f32."""
        h, hd = self.n_heads, self.hd
        return {"C": torch.zeros((batch, h, hd, hd), device=device),
                "n": torch.zeros((batch, h, hd), device=device),
                "m": torch.full((batch, h), M_INIT, device=device)}

    def state_axes(self):
        return {"C": ("batch", "heads", None, None), "n": ("batch", "heads", None),
                "m": ("batch", "heads")}

    def decode(self, p, x, state):
        """One token.  x: (B, 1, D) -> (y, state), the state updated IN
        PLACE."""
        B = x.shape[0]
        xu, z = self._up(p, x)
        q, k, v, i_pre, f_pre = self._gates_qkv(p, xu)
        C, n, m, y = mlstm_recurrent_step(state["C"], state["n"], state["m"], q[:, 0],
                                          k[:, 0], v[:, 0], i_pre[:, 0], f_pre[:, 0])
        out = self._out(p, x, y.reshape(B, 1, self.d_inner), z)
        for key, t in (("C", C), ("n", n), ("m", m)):
            state[key].copy_(t)
        return out, state


@dataclasses.dataclass(frozen=True)
class SLSTMBlock(Module):
    """sLSTM block: a scalar-memory recurrent cell with per-head recurrent
    mixing, strictly sequential over time (JAX's `lax.scan` is a Python
    loop here); the input and output projections ride the MX dispatch."""

    d_model: int
    n_heads: int

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads

    def build(self, mk: Builder):
        d, h, hd = self.d_model, self.n_heads, self.hd
        return {
            "ln": mk.param("ln", (d,), ("embed",), init="ones"),
            "w_in": mk.param("w_in", (d, 4 * d), ("embed", "mlp")),  # i, f, z, o
            "r": mk.param("r", (h, hd, 4 * hd), ("heads", None, None), scale=0.02),
            "b": mk.param("b", (4 * d,), ("mlp",), init="zeros"),
            "norm_w": mk.param("norm_w", (d,), ("embed",), init="ones"),
            "out": mk.param("out", (d, d), ("embed", "embed")),
        }

    def _pre(self, p, x):
        """The input pre-activations (..., 4 d) of rms_norm(x)."""
        return ops.matmul(rms_norm(x, p["ln"]), p["w_in"], out_dtype=x.dtype) + \
            p["b"].to(x.dtype)

    def _cell(self, p, pre, state):
        """pre: (B, H, 4 hd); state (h, c, n, m), each (B, H, hd) f32."""
        h_prev, c_prev, n_prev, m_prev = state
        rec = torch.einsum("bhd,hde->bhe", h_prev, p["r"].to(h_prev.dtype))
        i_pre, f_pre, z_pre, o_pre = torch.split((pre + rec).float(), self.hd, dim=-1)
        lf = F.logsigmoid(f_pre)
        m_new = torch.maximum(lf + m_prev, i_pre)
        ip = torch.exp(i_pre - m_new)
        fp = torch.exp(lf + m_prev - m_new)
        c_new = fp * c_prev + ip * torch.tanh(z_pre)
        n_new = fp * n_prev + ip
        h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1e-6)
        return h_new, c_new, n_new, m_new

    def _out(self, p, x, y):
        return x + ops.matmul(rms_norm(y, p["norm_w"]), p["out"], out_dtype=x.dtype)

    def __call__(self, p, x):
        B, L, d = x.shape
        h, hd = self.n_heads, self.hd
        pre = self._pre(p, x).reshape(B, L, h, 4 * hd)
        state = self.init_state(B, device=x.device)
        state = (state["h"], state["c"], state["n"], state["m"])
        hs = []
        for t in range(L):
            state = self._cell(p, pre[:, t], state)
            hs.append(state[0])
        y = torch.stack(hs, dim=1).reshape(B, L, d).to(x.dtype)
        return self._out(p, x, y)

    def init_state(self, batch: int, *, device="cuda"):
        """h, c, n (batch, H, hd) zeroed and m at -1e30, all f32 (separate
        tensors: decode writes them in place)."""
        shape = (batch, self.n_heads, self.hd)
        return {"h": torch.zeros(shape, device=device), "c": torch.zeros(shape, device=device),
                "n": torch.zeros(shape, device=device),
                "m": torch.full(shape, M_INIT, device=device)}

    def state_axes(self):
        ax = ("batch", "heads", None)
        return {"h": ax, "c": ax, "n": ax, "m": ax}

    def decode(self, p, x, state):
        """One token.  x: (B, 1, D) -> (y, state), the state updated IN
        PLACE."""
        B = x.shape[0]
        pre = self._pre(p, x).reshape(B, self.n_heads, 4 * self.hd)
        new = self._cell(p, pre, (state["h"], state["c"], state["n"], state["m"]))
        out = self._out(p, x, new[0].reshape(B, 1, self.d_model).to(x.dtype))
        for key, t in zip(("h", "c", "n", "m"), new):
            state[key].copy_(t)
        return out, state
