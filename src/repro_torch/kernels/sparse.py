"""2:4 structured weight sparsity: pruner, wire format and expand (port of
`repro/kernels/sparse.py`, byte for byte the same wire format).

Of every 4 consecutive elements along the contraction axis K, the 2
largest-magnitude survive.  The weight then travels as

  - the payload: the kept values, (..., K/2, N), in the weight's own dtype
    (an int8 payload when the policy quantizes), and
  - the metadata: the kept positions, 2 bits each, packed 2 groups per
    byte: uint8 (..., K/8, N).  bits[1:0] = group 2b's first index,
    bits[3:2] its second, bits[5:4] / bits[7:6] group 2b+1's pair; the
    indices are strictly increasing within a group.

`expand_24` is the plain decompress.  The CUDA GEMMs expand each staged
payload block and its metadata block with the same compare-select rule --
in registers on the decode tile (`csrc/decode_tile.cuh` `expand_row`), in
shared memory on the tensor cores (`csrc/prefill_tile.cuh`) -- so their
output is bitwise that of the dense kernel on `expand_24`'s weight.

An expert stack (G, K, N) is pruned and compressed one expert at a time
(`prune_24` / `compress_24` on a 3-D input), so no temporary of a whole
stack is made: grok-1's stacks are 6.4 GB each in f32.
"""
from __future__ import annotations

from typing import Tuple

import torch

GROUP = 4  # M of N:M
KEEP = 2   # N of N:M
GROUPS_PER_BYTE = 2  # 2 indices x 2 bits = 4 bits per group


def _check_k(k: int, *, what: str = "contraction dim") -> None:
    if k % (GROUP * GROUPS_PER_BYTE) != 0:
        raise ValueError(
            f"2:4 wire format needs {what} divisible by "
            f"{GROUP * GROUPS_PER_BYTE} (payload halves, metadata packs "
            f"{GROUPS_PER_BYTE} groups/byte); got {k}")


def _keep_mask(g: torch.Tensor) -> torch.Tensor:
    """(..., K/4, 4, N) -> bool mask of the 2 largest |.| per group, ties
    to the lower position: JAX's stable argsort of -|w|, as a rank by
    comparisons (rank_i = #{j: |w_j| > |w_i|} + #{j < i: |w_j| == |w_i|})."""
    mag = g.float().abs()
    rank = torch.zeros(mag.shape, dtype=torch.uint8, device=g.device)
    for i in range(GROUP):
        mi = mag[..., i, :]
        r = rank[..., i, :]
        for j in range(GROUP):
            if j == i:
                continue
            mj = mag[..., j, :]
            beats = (mj > mi) | (mj == mi) if j < i else mj > mi
            r += beats
    return rank < KEEP


def prune_24(w: torch.Tensor) -> torch.Tensor:
    """Magnitude 2:4 prune along K (axis -2) of (..., K, N) weights, K % 4
    == 0: every group of 4 keeps its 2 largest |.| entries, ties to the
    lower K position, so prune(prune(w)) == prune(w)."""
    *lead, K, N = w.shape
    if K % GROUP != 0:
        raise ValueError(f"K={K} must be divisible by {GROUP} for 2:4 pruning")
    if w.dim() == 3:
        out = torch.empty_like(w)
        for e in range(w.shape[0]):
            out[e] = prune_24(w[e])
        return out
    g = w.reshape(*lead, K // GROUP, GROUP, N)
    return torch.where(_keep_mask(g), g, torch.zeros_like(g)).reshape(w.shape)


def compress_24(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack an already 2:4-pruned (..., K, N) weight (K % 8 == 0) into
    (payload (..., K/2, N) in w's dtype, metadata uint8 (..., K/8, N)).
    The kept positions are the group's nonzeros in position order, zero
    positions filling in when a group has fewer than 2; more than 2
    nonzeros keeps the 2 earliest (always prune first)."""
    *lead, K, N = w.shape
    _check_k(K)
    if w.dim() == 3:
        payload = torch.empty((w.shape[0], K // KEEP, N), dtype=w.dtype, device=w.device)
        meta = torch.empty((w.shape[0], K // 8, N), dtype=torch.uint8, device=w.device)
        for e in range(w.shape[0]):
            payload[e], meta[e] = compress_24(w[e])
        return payload, meta
    g = w.reshape(*lead, K // GROUP, GROUP, N)
    pos = torch.arange(GROUP, dtype=torch.uint8, device=w.device).reshape(GROUP, 1)
    # nonzeros (in position order) before zeros (in position order): the
    # two smallest keys are the kept pair
    key = torch.where(g != 0, pos, pos + GROUP)
    rank = torch.zeros(key.shape, dtype=torch.uint8, device=w.device)
    for j in range(GROUP):
        rank += key[..., j:j + 1, :] < key
    kept = rank < KEEP
    idx0 = torch.where(kept, pos, GROUP).amin(dim=-2)  # (..., K/4, N)
    idx1 = torch.where(kept, pos, 0).amax(dim=-2)
    idx = torch.stack([idx0, idx1], dim=-2).long()  # (..., K/4, 2, N)
    payload = torch.gather(g, -2, idx).reshape(*lead, K // KEEP, N)
    nibble = idx0 | (idx1 << 2)
    nib2 = nibble.reshape(*lead, K // (GROUP * GROUPS_PER_BYTE), GROUPS_PER_BYTE, N)
    meta = nib2[..., 0, :] | (nib2[..., 1, :] << 4)
    return payload, meta


def expand_24(payload: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """(payload, metadata) back to the dense (..., K, N) weight: dense row
    4g+j is (i0 == j ? payload[2g] : 0) + (i1 == j ? payload[2g+1] : 0)
    -- compare-selects, as JAX adds them (so a kept -0.0 reads back +0.0
    in both packages)."""
    *lead, K2, N = payload.shape
    K = K2 * KEEP
    if tuple(meta.shape) != (*lead, K // (GROUP * GROUPS_PER_BYTE), N):
        raise ValueError(
            f"metadata shape {tuple(meta.shape)} does not match payload "
            f"{tuple(payload.shape)} (want (..., {K // (GROUP * GROUPS_PER_BYTE)}, "
            f"{N}))")
    nib = torch.stack([meta & 0xF, meta >> 4], dim=-2)
    nib = nib.reshape(*lead, K // GROUP, N).to(torch.int32)
    i0 = nib & 3
    i1 = (nib >> 2) & 3
    p = payload.reshape(*lead, K // GROUP, KEEP, N)
    p0, p1 = p[..., 0, :], p[..., 1, :]
    zero = torch.zeros_like(p0)
    dense = torch.stack([torch.where(i0 == j, p0, zero) + torch.where(i1 == j, p1, zero)
                         for j in range(GROUP)], dim=-2)
    return dense.reshape(*lead, K, N)


def sparse_b_bytes_per_elem(payload_itemsize: int) -> float:
    """Device-memory bytes per DENSE weight element the wire format moves:
    half the payload itemsize plus 2 bits per kept index (4 bits per group
    of 4).  f32 -> 2.125 (0.53125x), int8 -> 0.625 (0.15625x of f32)."""
    return payload_itemsize / KEEP + 1.0 / (GROUP * GROUPS_PER_BYTE)
