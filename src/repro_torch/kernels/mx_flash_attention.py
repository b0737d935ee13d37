"""Flash attention (port of `repro/kernels/mx_flash_attention.py::
mx_flash_attention`).

On a CUDA tensor the wrapper launches `csrc/mx_flash_attention.cu`: one
grid over (head, batch, q tile) of the model's (B, S, H, d) tensors, query
head h reading kv head h // (H / Hkv), both products on the tensor cores
(bf16 m16n8k16; f32 as 3xTF32), K and V tiles through a ring of 16-byte
async copies, the online-softmax statistics and the output tile in f32
registers across the KV walk, one store per output row; under the causal
mask KV tiles wholly above the diagonal are not read.  The probabilities
enter the PV product in f32 precision whatever the dtype, as in JAX (whose
kernel widens v to f32): bf16 as a pair of bf16 products (hi + lo).  On a
CPU tensor it runs the plain version (`kernels.ref.flash_attention_plain`,
`_flash_kernel`'s online softmax).

q (B, Lq, H, d), k and v (B, Lk, Hkv, d) -- or one head as JAX's kernel
takes it: q (Lq, d), k and v (Lk, d).  The causal mask is top-left
(qpos >= kpos), as in the TPU kernel; Lq may differ from Lk.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import flash_attention_plain

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 4 + (_I,) * 8 + (_F, _I, _I, _P)
# the CTA per dtype: warps of 16 query rows each, and the depth of the KV
# copy ring (tools/attention_variants.py times the others)
TILES = {torch.float32: (4, 2), torch.bfloat16: (8, 3)}


def mx_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v per head, right padding and (with
    `causal`) the top-left causal mask applied before the running max.
    Shapes in the module docstring; q, k, v f32 or bf16 of one dtype on
    the card.  Returns q's shape and dtype."""
    single = q.dim() == 2
    if single:
        q, k, v = q[None, :, None], k[None, :, None], v[None, :, None]
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q (B, Lq, H, d), k / v (B, Lk, Hkv, d): got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Lq, H, d = q.shape
    if k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} vs k {tuple(k.shape)}")
    Lk, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"H={H} not a multiple of Hkv={Hkv}")
    _build.refuse_grad("mx_flash_attention", q, k, v)
    if not q.is_cuda:
        out = flash_attention_plain(q, k, v, causal=causal)
        return out[0, :, 0] if single else out
    dt = _build.dtype_code(q.dtype, "mx_flash_attention q")
    for t, what in ((k, "k"), (v, "v")):
        if t.dtype != q.dtype:
            raise TypeError(f"mx_flash_attention: {what} is {t.dtype}, q is {q.dtype}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.device != q.device:
            raise ValueError(f"{what} is on {t.device}, expected {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"mx_flash_attention: {what} must be contiguous")
    out = torch.empty_like(q)
    if B * Lq * H == 0:
        return out[0, :, 0] if single else out
    fn = _build.function("mx_flash_attention", "mx_flash_attention_launch", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Lq, Lk, H, Hkv,
             d, int(causal), dt, 1.0 / math.sqrt(d), *TILES[q.dtype], _build.stream_ptr(q))
    _build.check(err, "mx_flash_attention", f"mx_flash_attention at d={d}, Lk={Lk} (the "
                 "kernel takes a head dim of at most 128 and at least one key)")
    mx_flash_attention.launches += 1
    return out[0, :, 0] if single else out


mx_flash_attention.launches = 0  # kernel launches (CUDA tensors only)
