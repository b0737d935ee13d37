"""Ring collective GEMMs (port of `repro/kernels/mx_collective_matmul.py`).

Not kernels of their own: a sharded GEMM cut into one chunk GEMM per ring
step, each chunk GEMM kernel 1 (`mx_matmul_fused`) on "cuda_mx" while the
ring (`parallel/ring.py`) moves the next chunk to the neighbour.

  ``ring_allgather_matmul``  — all-gather x matmul.  x is sharded on M, w
      on N (q / k / v and up projections).  Each step multiplies the
      resident M-chunk of x by the local w shard and writes that chunk's
      output rows with the epilogue fused into its write-back (each output
      element is written once); the chunk moves on around the ring.

  ``ring_matmul_reduce_scatter`` — matmul x reduce-scatter.  x and w are
      sharded on K (out and down projections).  The f32 partial sum of
      chunk j travels the ring gaining each rank's contribution and arrives
      fully summed at its owner on the last step, where the epilogue is
      applied once: without an activation the incoming partial (plus the
      residual) rides kernel 1's residual slot, so the last addition happens
      at the write-back; with one, the epilogue runs unfused after the raw
      GEMM.  A gate raises (it would need the gate's full sum).

Both take "fwd", "bwd" and "bidir" rings; bidir sends the two halves of
each chunk around opposite rings and runs them as ONE chunk GEMM per step.

The bodies are JAX's per-shard bodies with every per-rank value a list over
the ranks this process holds (`ring.ranks`, each position's axis index):
all P for a `LocalRing`, one for a `DistRing`.  Each hop is started before
the step's GEMMs and waited for after them.

ABFT (``ChunkCompute(abft=True)``): every chunk GEMM takes kernel 1's
checksummed variant (its flag map summed on the device), and column-sum
sidecars travel with each payload, re-derived and compared exactly by the
receiver; a `RingFault` corrupts one traveling payload on rank 0.  The
bodies then return (outs, n_flags), n_flags a device scalar summed over
the ring.

``serialized_allgather_matmul`` / ``serialized_matmul_psum`` are the
unoverlapped patterns (gather then one GEMM; GEMM then psum), the rings'
plain versions for the tests and `chip_smoke.py`.

`RING_STATS` counts ring linears and kernel-1 chunk launches per mode, the
linears that fell back to the single-device dispatch, and the host reads of
ABFT flag totals (`core/ops._collective_linear`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from .mx_matmul import Epilogue, abft_spec_for, apply_epilogue, dot_f32, mx_matmul_fused

DIRECTIONS = ("fwd", "bwd", "bidir")

# A ring fault (ABFT testing): (step, row, col, delta) — corrupt one element
# of the TRAVELING payload (the x chunk on the all-gather ring, the partial
# accumulator on the reduce-scatter ring) on rank 0 at the given ring step,
# after the sidecar closed over the clean bits and before the verify.
RingFault = Tuple[int, int, int, float]

RING_STATS = {"allgather": 0, "reduce_scatter": 0, "allgather_chunks": 0,
              "reduce_scatter_chunks": 0, "fallbacks": 0, "fallback_reasons": {},
              "flag_reads": 0}


def reset_ring_stats() -> None:
    for k in RING_STATS:
        RING_STATS[k] = {} if k == "fallback_reasons" else 0


def ring_stats() -> dict:
    return {k: dict(v) if isinstance(v, dict) else v for k, v in RING_STATS.items()}


def _ring_colsum(chunk: torch.Tensor) -> torch.Tensor:
    """Checksum sidecar of a traveling payload: its f32 column sums.  The
    verify recomputes this same reduction on the received bits, so the
    compare is exact for every payload dtype."""
    return chunk.float().sum(dim=0, keepdim=True)


def _ring_fault(arr: torch.Tensor, idx: int, fault: Optional[RingFault],
                step: int) -> torch.Tensor:
    """A copy of `arr` with the fault applied if it targets this step and
    this is rank 0; else `arr` itself."""
    if fault is None or step != fault[0] or idx != 0:
        return arr
    r, c = fault[1] % arr.shape[0], fault[2] % arr.shape[1]
    out = arr.clone()
    out[r, c] += torch.tensor(float(fault[3])).to(device=arr.device, dtype=arr.dtype)
    return out


def _sidecar_mismatch(chunk: torch.Tensor, sidecar: torch.Tensor) -> torch.Tensor:
    return (_ring_colsum(chunk) != sidecar).any().to(torch.int32)


def ring_perm(axis_size: int, *, reverse: bool = False) -> List[Tuple[int, int]]:
    """(src, dst) pairs of a unidirectional ring over `axis_size` ranks."""
    if reverse:
        return [(i, (i - 1) % axis_size) for i in range(axis_size)]
    return [(i, (i + 1) % axis_size) for i in range(axis_size)]


def _at(values, i):
    return None if values is None else values[i]


@dataclasses.dataclass(frozen=True)
class ChunkCompute:
    """How each ring step's chunk GEMM runs: "cuda_mx" is kernel 1,
    `mx_matmul_fused` (its plain version on CPU tensors, as everywhere);
    every other backend the plain unfused reference (`dot_f32` +
    `apply_epilogue`), as JAX maps every backend but "pallas_mx" to its
    "xla" reference, "cuda_baseline" (JAX's "pallas_baseline") included.
    With ``abft`` raw() / fused() return (y, n_flagged_tiles), a device
    scalar (0 on the reference, which has no tile write-back to verify)."""

    backend: str = "torch"
    abft: bool = False

    def _kernel(self, a, b, **kw):
        spec = abft_spec_for(a, b) if self.abft else None
        y = mx_matmul_fused(a, b, abft=spec, **kw)
        if self.abft:
            y, flags = y
            return y, flags.sum(dtype=torch.int32)
        return y

    def _flagged(self, y):
        return (y, torch.zeros((), dtype=torch.int32, device=y.device)) if self.abft else y

    def raw(self, a, b, a_scale=None, b_scale=None):
        """Plain chunk GEMM, f32 out, no epilogue (partial sums); quantized
        chunks are dequantized into the partial at its write-back."""
        if self.backend == "cuda_mx":
            ep = Epilogue(a_scale=a_scale is not None, b_scale=b_scale is not None)
            return self._kernel(a, b, epilogue=ep, a_scale=a_scale, b_scale=b_scale,
                                out_dtype=torch.float32)
        y = dot_f32(a, b)
        if a_scale is not None:
            y = y * a_scale
        if b_scale is not None:
            y = y * b_scale
        return self._flagged(y)

    def fused(self, a, b, *, epilogue: Epilogue, bias=None, residual=None, b_gate=None,
              a_scale=None, b_scale=None, bg_scale=None, out_dtype=None):
        """Chunk GEMM with the epilogue in its write-back (kernel 1) or as
        the same unfused op chain (reference); the scale flags follow the
        operands."""
        out_dtype = out_dtype or a.dtype
        epilogue = dataclasses.replace(epilogue, a_scale=a_scale is not None,
                                       b_scale=b_scale is not None)
        if self.backend == "cuda_mx":
            return self._kernel(a, b, epilogue=epilogue, b_gate=b_gate, bias=bias,
                                residual=residual, a_scale=a_scale, b_scale=b_scale,
                                bg_scale=bg_scale, out_dtype=out_dtype)
        y = dot_f32(a, b)
        gate = dot_f32(a, b_gate) if epilogue.has_gate else None
        return self._flagged(apply_epilogue(
            y, epilogue, bias=bias, gate=gate, residual=residual, a_scale=a_scale,
            b_scale=b_scale, bg_scale=bg_scale, out_dtype=out_dtype))


def _check_direction(direction: str) -> None:
    if direction not in DIRECTIONS:
        raise ValueError(f"unknown ring direction {direction!r}; one of {DIRECTIONS}")


class _Flags:
    """Per-position ABFT flag totals (device scalars), summed over the ring
    at the end."""

    def __init__(self, on: bool, like: Sequence[torch.Tensor]):
        self.on = on
        self.n = [torch.zeros((), dtype=torch.int32, device=t.device) for t in like] \
            if on else None

    def add(self, i: int, nf) -> None:
        self.n[i] = self.n[i] + nf

    def unpack(self, i: int, y):
        """y's output, its chunk-GEMM flags added in."""
        if not self.on:
            return y
        y, nf = y
        self.add(i, nf)
        return y

    def done(self, ring, outs, mode: str, launched0: int):
        if isinstance(outs[0], dict):  # the all-gather ring's pieces, in row order
            outs = [torch.cat([p[r] for r in sorted(p)]) for p in outs]
        RING_STATS[mode] += 1
        RING_STATS[f"{mode}_chunks"] += mx_matmul_fused.launches - launched0
        return (outs, ring.psum(self.n)) if self.on else outs


# ---------------------------------------------------------------------------
# all-gather x matmul
# ---------------------------------------------------------------------------


def ring_allgather_matmul(ring, x_shards, w_shards, *, compute: ChunkCompute = ChunkCompute(),
                          epilogue: Epilogue = Epilogue(), bias=None, residual=None,
                          b_gate=None, a_scale=None, b_scale=None, bg_scale=None,
                          out_dtype=None, direction: str = "bidir",
                          fault: Optional[RingFault] = None):
    """out = epilogue(all_gather_M(x) @ w_shard) for each rank this process
    holds.  Per position i (rank ring.ranks[i]): x_shards[i] (m_loc, K), the
    rank's M-rows; w_shards[i] (K, n_loc) and b_gate[i]; bias[i] (n_loc,);
    residual[i] (P*m_loc, n_loc), every row of the rank's N-shard;
    a_scale[i] (m_loc, 1), the rank's per-row scales, which TRAVEL with
    their x chunk; b_scale[i] / bg_scale[i] (1, n_loc), resident like the
    weight shard.  Returns the (P*m_loc, n_loc) outputs, or (outs, n_flags)
    under ABFT (each chunk's owner takes a checksum sidecar once, at step
    0; it travels with the chunk, and every rank compares it with the same
    reduction of the bits it is about to multiply)."""
    _check_direction(direction)
    P, L = ring.size, ring.ranks
    m_loc = x_shards[0].shape[0]
    out_dtype = out_dtype or x_shards[0].dtype
    pieces = [{} for _ in L]  # per position: first output row -> that chunk's rows
    flags = _Flags(compute.abft, x_shards)
    launched0 = mx_matmul_fused.launches

    def gemm(i, a, res, a_s):
        return flags.unpack(i, compute.fused(
            a, w_shards[i], epilogue=epilogue, bias=_at(bias, i), residual=res,
            b_gate=_at(b_gate, i), a_scale=a_s, b_scale=_at(b_scale, i),
            bg_scale=_at(bg_scale, i), out_dtype=out_dtype))

    def hop(travel, perms):
        """Start the hops of every traveling list (payloads and sidecars)."""
        return {k: ring.permute(v, perms[k]) for k, v in travel.items() if v is not None}

    if direction == "bidir" and P > 1 and m_loc % 2 == 0:
        half = m_loc // 2
        # the halves of each chunk and their sidecars, around opposite rings
        t = {"f": [x[:half] for x in x_shards], "b": [x[half:] for x in x_shards],
             "sf": None if a_scale is None else [s[:half] for s in a_scale],
             "sb": None if a_scale is None else [s[half:] for s in a_scale]}
        t["cf"] = [_ring_colsum(v) for v in t["f"]] if compute.abft else None
        t["cb"] = [_ring_colsum(v) for v in t["b"]] if compute.abft else None
        fwd, bwd = ring_perm(P), ring_perm(P, reverse=True)
        perms = {"f": fwd, "sf": fwd, "cf": fwd, "b": bwd, "sb": bwd, "cb": bwd}
        for step in range(P):
            # start the hops first: they overlap this step's GEMMs
            hops = hop(t, perms) if step < P - 1 else {}
            used = [_ring_fault(v, idx, fault, step) for v, idx in zip(t["f"], L)]
            for i, idx in enumerate(L):
                if compute.abft:
                    flags.add(i, _sidecar_mismatch(used[i], t["cf"][i]))
                    flags.add(i, _sidecar_mismatch(t["b"][i], t["cb"][i]))
                # the owners of the forward- and the backward-moving halves
                rf, rb = (idx - step) % P * m_loc, (idx + step) % P * m_loc + half
                res = None if residual is None else torch.cat(
                    [residual[i][rf:rf + half], residual[i][rb:rb + half]])
                a_s = None if a_scale is None else torch.cat([t["sf"][i], t["sb"][i]])
                y = gemm(i, torch.cat([used[i], t["b"][i]]), res, a_s)
                pieces[i][rf], pieces[i][rb] = y[:half], y[half:]
            t.update({k: h.wait() for k, h in hops.items()})
        return flags.done(ring, pieces, "allgather", launched0)

    perm = ring_perm(P, reverse=(direction == "bwd"))
    t = {"x": list(x_shards), "s": a_scale,
         "c": [_ring_colsum(v) for v in x_shards] if compute.abft else None}
    for step in range(P):
        hops = hop(t, dict.fromkeys(t, perm)) if step < P - 1 else {}
        used = [_ring_fault(v, idx, fault, step) for v, idx in zip(t["x"], L)]
        for i, idx in enumerate(L):
            if compute.abft:
                # verify the bits about to feed the GEMM against the owner's
                # sidecar: a corruption on any hop, or after receipt
                flags.add(i, _sidecar_mismatch(used[i], t["c"][i]))
            # forward hops (i -> i+1): after `step` hops rank idx holds (idx - step)'s rows
            r0 = ((idx + step) if direction == "bwd" else (idx - step)) % P * m_loc
            res = None if residual is None else residual[i][r0:r0 + m_loc]
            pieces[i][r0] = gemm(i, used[i], res, _at(t["s"], i))
        t.update({k: h.wait() for k, h in hops.items()})
    return flags.done(ring, pieces, "allgather", launched0)


def serialized_allgather_matmul(ring, x_shards, w_shards, *,
                                compute: ChunkCompute = ChunkCompute(),
                                epilogue: Epilogue = Epilogue(), bias=None, residual=None,
                                b_gate=None, a_scale=None, b_scale=None, bg_scale=None,
                                out_dtype=None):
    """The unoverlapped reference: gather x over M (and its per-row scales),
    then one GEMM per rank."""
    if compute.abft:
        raise ValueError("serialized references do not support ABFT compute")
    x_full = ring.gather(x_shards, 0)
    a_s = ring.gather(a_scale, 0) if a_scale is not None else None
    return [compute.fused(x_full, w_shards[i], epilogue=epilogue, bias=_at(bias, i),
                          residual=_at(residual, i), b_gate=_at(b_gate, i), a_scale=a_s,
                          b_scale=_at(b_scale, i), bg_scale=_at(bg_scale, i),
                          out_dtype=out_dtype or x_shards[0].dtype)
            for i in range(len(ring.ranks))]


# ---------------------------------------------------------------------------
# matmul x reduce-scatter
# ---------------------------------------------------------------------------


def ring_matmul_reduce_scatter(ring, x_shards, w_shards, *,
                               compute: ChunkCompute = ChunkCompute(),
                               epilogue: Epilogue = Epilogue(), bias=None, residual=None,
                               a_scale=None, b_scale=None, out_dtype=None,
                               direction: str = "bidir",
                               fault: Optional[RingFault] = None):
    """out = epilogue(psum(x_shard @ w_shard))[own M-chunk] for each rank
    this process holds.  Per position i: x_shards[i] (M, k_loc), every row,
    the rank's K-columns; w_shards[i] (k_loc, N); bias[i] (N,);
    residual[i] (M/P, N), the rank's output rows; a_scale[i] (M, 1) and
    b_scale[i] (1, N), shard-local (per-row / per-column scales are
    constant along K, and each chunk GEMM dequantizes into its f32
    partial, so nothing but f32 partial sums travels).  Returns the (M/P,
    N) outputs, or (outs, n_flags) under ABFT: the sender takes a fresh
    checksum sidecar of each partial after adding its contribution, and the
    receiver compares it before adding; ``fault`` corrupts a received
    partial (step >= 1)."""
    _check_direction(direction)
    if epilogue.has_gate:
        raise ValueError("swiglu epilogue is not supported on the "
                         "reduce-scatter path (gate needs the full sum)")
    P, L = ring.size, ring.ranks
    M, _ = x_shards[0].shape
    N = w_shards[0].shape[1]
    if M % P:
        raise ValueError(f"M={M} must divide over the ring size {P}")
    m_loc = M // P
    out_dtype = out_dtype or x_shards[0].dtype
    flags = _Flags(compute.abft, x_shards)
    launched0 = mx_matmul_fused.launches

    def rows(i, t, start, n):
        return None if t is None else t[i][start:start + n]

    def fused_final(i, xr, acc_in, res, a_s):
        """The last step: this rank's contribution + the incoming partial +
        the epilogue.  Without an activation in ONE chunk-GEMM write-back
        (the partial, plus the residual, in the residual slot, added after
        the chunk's dequant scales); with one, act(full sum) needs the sum
        first, so the epilogue runs unfused after the raw GEMM."""
        if epilogue.activation == "none":
            extra = acc_in if res is None else acc_in + res.float()
            ep = Epilogue(bias=bias is not None, residual=True, out_scale=epilogue.out_scale)
            return flags.unpack(i, compute.fused(
                xr, w_shards[i], epilogue=ep, bias=_at(bias, i), residual=extra,
                a_scale=a_s, b_scale=_at(b_scale, i), out_dtype=out_dtype))
        y = flags.unpack(i, compute.raw(xr, w_shards[i], a_s, _at(b_scale, i)))
        return apply_epilogue(y + acc_in, epilogue, bias=_at(bias, i), residual=res,
                              out_dtype=out_dtype)

    def received(got, step, faulty=True):
        """The partials of one hop (got: the payloads, then their sidecars
        under ABFT), the fault applied, each sidecar compared."""
        out = []
        for i, t in enumerate(got[0]):
            if faulty:
                t = _ring_fault(t, L[i], fault, step)
            if compute.abft:
                flags.add(i, _sidecar_mismatch(t, got[1][i]))
            out.append(t)
        return out

    if direction == "bidir" and P > 1 and m_loc % 2 == 0:
        half = m_loc // 2
        perm_f, perm_b = ring_perm(P), ring_perm(P, reverse=True)
        for step in range(P):
            jf = [(idx - step - 1) % P for idx in L]  # fwd ring: chunk jf's top half
            jb = [(idx + step + 1) % P for idx in L]  # bwd ring: chunk jb's bottom half
            xs, a_ss = [], []
            for i in range(len(L)):
                xs.append(torch.cat([rows(i, x_shards, jf[i] * m_loc, half),
                                     rows(i, x_shards, jb[i] * m_loc + half, half)]))
                a_ss.append(None if a_scale is None else torch.cat(
                    [rows(i, a_scale, jf[i] * m_loc, half),
                     rows(i, a_scale, jb[i] * m_loc + half, half)]))
            if step == P - 1:  # jf == jb == idx: fully summed, fuse the epilogue
                got = [h.wait() for h in hops]
                af, ab = received(got[0::2], step), received(got[1::2], step, faulty=False)
                outs = [fused_final(i, xs[i], torch.cat([af[i], ab[i]]), _at(residual, i),
                                    a_ss[i]) for i in range(len(L))]
                return flags.done(ring, outs, "reduce_scatter", launched0)
            # this step's GEMMs first: they overlap the hops started last step
            ys = [flags.unpack(i, compute.raw(xs[i], w_shards[i], a_ss[i], _at(b_scale, i)))
                  for i in range(len(L))]
            if step == 0:
                acc_f, acc_b = [y[:half] for y in ys], [y[half:] for y in ys]
            else:
                got = [h.wait() for h in hops]
                af, ab = received(got[0::2], step), received(got[1::2], step, faulty=False)
                acc_f = [y[:half] + a for y, a in zip(ys, af)]
                acc_b = [y[half:] + b for y, b in zip(ys, ab)]
            hops = [ring.permute(acc_f, perm_f), ring.permute(acc_b, perm_b)]
            if compute.abft:
                # fresh sidecars over the just-updated partials: the next
                # hop verifies the sum it receives
                hops += [ring.permute([_ring_colsum(t) for t in acc_f], perm_f),
                         ring.permute([_ring_colsum(t) for t in acc_b], perm_b)]

    perm = ring_perm(P, reverse=(direction == "bwd"))
    sgn = -1 if direction != "bwd" else 1
    for step in range(P):
        j = [(idx + sgn * (step + 1)) % P for idx in L]  # the chunk handled this step
        xr = [rows(i, x_shards, j[i] * m_loc, m_loc) for i in range(len(L))]
        a_s = [rows(i, a_scale, j[i] * m_loc, m_loc) for i in range(len(L))]
        if step == P - 1:  # j == idx
            recv = (received([h.wait() for h in hops], step) if P > 1 else
                    [torch.zeros((m_loc, N), dtype=torch.float32, device=x.device)
                     for x in x_shards])
            outs = [fused_final(i, xr[i], recv[i], _at(residual, i), a_s[i])
                    for i in range(len(L))]
            return flags.done(ring, outs, "reduce_scatter", launched0)
        # this step's GEMMs first: they overlap the hop started last step
        ys = [flags.unpack(i, compute.raw(xr[i], w_shards[i], a_s[i], _at(b_scale, i)))
              for i in range(len(L))]
        acc = ys if step == 0 else [
            y + r for y, r in zip(ys, received([h.wait() for h in hops], step))]
        hops = [ring.permute(acc, perm)]
        if compute.abft:
            hops.append(ring.permute([_ring_colsum(t) for t in acc], perm))
    raise AssertionError("unreachable: the P-step loop returns at step P-1")


def serialized_matmul_psum(ring, x_shards, w_shards, *,
                           compute: ChunkCompute = ChunkCompute(),
                           epilogue: Epilogue = Epilogue(), bias=None, residual=None,
                           a_scale=None, b_scale=None, out_dtype=None):
    """The unoverlapped reference: each rank's full partial GEMM
    (dequantized at its write-back), psum in rank order, the epilogue on
    each rank's own M-chunk (psum + slice == reduce-scatter)."""
    if compute.abft:
        raise ValueError("serialized references do not support ABFT compute")
    if epilogue.has_gate:
        raise ValueError("swiglu epilogue is not supported on the "
                         "reduce-scatter path (gate needs the full sum)")
    P = ring.size
    M = x_shards[0].shape[0]
    if M % P:
        raise ValueError(f"M={M} must divide over the ring size {P}")
    m_loc = M // P
    y = ring.psum([compute.raw(x_shards[i], w_shards[i], _at(a_scale, i), _at(b_scale, i))
                   for i in range(len(ring.ranks))])
    return [apply_epilogue(y[idx * m_loc:(idx + 1) * m_loc], epilogue, bias=_at(bias, i),
                           residual=_at(residual, i),
                           out_dtype=out_dtype or x_shards[0].dtype)
            for i, idx in enumerate(ring.ranks)]
