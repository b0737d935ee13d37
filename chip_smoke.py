#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. device check: requires CUDA, prints the card's name and power limit,
     turns TF32 off (the plain versions and the tied head run in full f32);
  2. builds the CUDA kernels from src/repro_torch/csrc with nvcc (sm_90a),
     one nvcc per source, all started together, and prints each kernel's
     registers and spills; requires the baseline library's SASS to hold its
     output round trip (ld/st.global.cg) and the MX library's none, and
     every prefill-tile kernel (csrc/prefill_tile.cuh) to hold tensor-core
     instructions (HMMA, IMMA, QMMA and their wgmma forms) and, outside
     ABFT, at most PREFILL_MAX_FFMA FFMAs (printed on a line before the
     last), every instantiation on int8 x int8 an 8-bit tensor-core
     product (IMMA; e4m3 x e4m3 runs f16 HMMAs of its exactly widened
     operands, sm_90 having no e4m3 mma.sync), every mx_flash_attention
     kernel and both ssd_scan kernels to hold HMMA, and every
     instantiation of the grouped GEMM's
     "mma" route (csrc/grouped_mma.cuh; dense, 2:4 and ABFT libraries) to
     hold HMMA and, outside ABFT, at most PREFILL_MAX_FFMA FFMAs; it also
     builds the grouped GEMM's copies-only timing variant (GROUPED_COPIES);
  3. holds each kernel against its plain PyTorch version at the shapes of
     the main path (llama3.2-1b, plus qwen2-0.5b's ragged widths and
     zamba2-2.7b's Mamba2 projections, N = 10448 off every tile), in f32
     and bf16: the GEMMs (the dense decode tile, M <= 16, at M = 1, 8 and
     16, with an operand 4 bytes off a 16-byte boundary, each launch's tile,
     ring depth and shared memory printed; the paper's A/B line, MX against
     the baseline at M = 8; M = 40, 64, 256 and 2048 on the tensor-core
     prefill tile, each with its tile, its 3xTF32 route bound and the
     library time, and the A/B there); flash
     decode with f32/bf16 and with int8 pages
     and scales, and at long context (8 slots of 2048 positions, f32 and
     bf16, with its TB/s); flash verify at S = 5 and 9, G = 7, poisoned
     stale pages and S = 1 (bitwise the decode kernel), with the same page
     types; each decode and verify row with its split (pages per span, span
     ring, cluster size, grid: kernels/_build.decode_split).
     Max error against 1e-4 * max|ref| (f32) / 2e-2 * max|ref| (bf16),
     kernel / plain / library time from CUDA events (the median of 5
     windows of 20 calls, taken in turns; every window's time goes to the
     JSON file), and the bound (the larger of bytes / 3.35 TB/s and
     FLOPs / peak; int8 pages count their payload and f32 scales);
  4. serves llama3.2-1b at full width (16 layers, f32, random weights from
     seed 0) through the port's paged continuous batcher with the prefix
     cache: 8 slots, 16 requests of 128 tokens sharing a 96-token system
     prompt, 32 new tokens each -- on the MX kernels (launches on the decode
     and prefill tiles counted), shorter on the
     baseline GEMM, then with speculation (k = 4; a trace drafter over the
     plain streams, and the n-gram drafter), with int8 pages (plain and
     k = 4 n-gram), and a short pass with the target itself as the draft
     model -- and requires every kernel's launch count > 0 on its path (the
     decode steps' GEMMs on the decode tile, MX and baseline) and
     every speculative stream equal to its plain stream (a divergence
     passes only at a near tie, see phase 5);
  5. holds the kernel path against the plain path: one prefill chunk, one
     decode step and one verify step (S = 5, f32 and int8 pages) on the
     same cache state under "cuda_mx" and "torch" (logits within 1e-3 *
     max|ref|; the verify step's plain path and the decode step that its
     row 0 is checked against attend over the pages the kernel path wrote;
     int8 pages the two paths write on their own within one quantum; every
     GEMM of the chunk and of the verify step on the prefill tile),
     profiles a prefill
     chunk and four decode steps and one verify step (device time by
     kernel, busy share), and requires identical token streams at smoke
     size across backends, plain and speculative, for f32 and int8 pages;
  6. frees llama and serves grok-1-314b at full width (d_model 6144, 48 /
     8 heads, 8 experts top-2, expert d_ff 32768, vocab 131072, untied
     head), its depth cut from 64 to 2 layers, f32 weights from seed 0,
     through the same batcher and trace (16 new tokens each): every expert
     GEMM runs `mx_grouped_matmul`, required at exactly 2 launches per MoE
     layer per step or prefill chunk; prints the peak device memory;
  7. holds grok's kernel path against its plain path on one cache state (a
     64-token chunk, G = 16 routing groups; a 31-token chunk, G = 1, where
     capacity drops are possible; a decode step) at 1e-3 * max|ref|, with
     the smallest 2nd-3rd router probability gap and the first routing flip
     between the paths (a flip at a router error <= 1e-4 is a near tie,
     not a fault), profiles one decode step, and requires identical token
     streams across backends at smoke size for grok-1 and kimi-k2.
Phase 3 also holds `mx_grouped_matmul` against `grouped_matmul_ref`: grok's
decode (T = 64, 8 rows per expert) and expert-major prefill (8 x 128 rows)
projections, ragged sizes with empty groups, tiles straddling four groups,
sum < T (tail rows exactly zero) and sum > T, T/K/N off the tiles, and
kimi-k2's 384 experts in bf16 (an 11.3 GB stack, offsets past 2^31); each
line prints the launch's route, tile, stages, split, parts, CTAs and TB/s,
the down projections `torch.bmm`'s time, and grok's decode down projection
the copies-only variant's time and TB/s (the weight stream's own rate).
Phase 3a adds the grouped ABFT case at grok's decode height (8 x 8 rows,
16-row tiles) in f32 and bf16, and phases 7 / 7q print the grouped
kernels' device time in each profiled decode step.

The quantized path (stages 1b and 5b of the GEMMs, fp8 KV pages):
  3q. every quantized operand pair -- (bf16, int8) "int8", (bf16, fp8)
      "fp8", (int8, int8) "int8_all", (fp8, fp8) "fp8_all" -- through both
      GEMMs at llama's decode and 64-row chunk widths and grok's expert
      widths, with the policies' own scales, against the plain versions
      within 1e-4 * max|ref| ("int8_all" with scales only bitwise; "fp8_all"
      with scales only also no more than twice as far from the f64 product
      as the plain version), each row at M > 16 printed with its route,
      tile and split; flash decode and verify over fp8 pages as over int8
      pages.  The bound counts payloads at their own bytes plus f32 scales;
      the library yardstick is torch._int_mm (int8 x int8) or
      torch._scaled_mm with row-wise scales (fp8 x fp8), and for grok's bare
      fp8 expert GEMMs torch._scaled_grouped_mm (its refusal printed where
      the card's torch refuses), where their shape rules allow;
  4q. (after phase 4, before any profiler session) llama3.2-1b on the same
      weights under Config.precision "int8" (the phase 4 trace),
      "int8_all" (a shorter pass) and "fp8" with fp8 pages (plain and
      k = 4 n-gram), each run's kernel-1 launches printed by route (its
      decode steps' on the decode tile, its prefill chunks' on the tensor
      cores, nothing else);
  5q. (after phase 5) each held against the plain path on one cache
      state: every GEMM call of a prefill chunk and a decode step against
      its plain version at 1e-3 * max|ref|, and the logits at half the
      quantization's own effect on them (quantized activations round
      last-bit differences of the two paths to neighbouring quanta); one
      step profiled; identical streams across backends at smoke size
      (llama under "int8", "int8_all", fp8 pages, "fp8" with fp8 pages);
  6q. (after phase 6) grok-1, the same cut, under "int8": its f32 weights
      on the card and the int8 payloads kept beside them (peak memory
      printed), 2 grouped launches per MoE layer per step or chunk;
  7q. (after phase 7) grok int8 held against the plain path as in 5q, a
      64-token chunk (G = 16) under "int8_tensor" (one activation amax per
      routing group), and identical smoke streams for grok-1 and kimi-k2
      under "int8" and "int8_all".
The 2:4 sparse and ABFT stages of the GEMMs (1c, 1d, 5c, 5d):
  3s. both GEMMs on every 2:4 pair -- (f32, f32) and (bf16, bf16)
      "sparse24", (bf16, int8) "sparse24_int8" -- at llama's decode and
      chunk widths, qwen2's ragged widths and grok's expert widths (empty
      groups, straddled tiles), against the plain versions at phase 3's
      tolerances and BITWISE against the dense kernel on expand_24(payload,
      meta); the bound counts payload and metadata bytes; the library
      yardstick is torch.sparse.to_sparse_semi_structured (bf16); each
      decode row printed with its decode tile (the payload's and the
      metadata's copy widths);
  3a. both GEMMs, ABFT on the six dense pairs and the three sparse policies
      (expanded first; the fused GEMM at M = 8 and at M = 40 and 65, the
      prefill tile's): on bitwise equal to off with no flag, an injected
      fault (in the last row tile, of 8 and 1 rows at M = 40 and 65) flags
      exactly its tile and the flag map equals the plain version's,
      recovery bitwise, the int8 pair catches a delta of 1,
      max_retries = 0 raises SDCError naming the tile; time on against off;
      each row printed with its decode or prefill tile;
  4s. (before any profiler session) llama3.2-1b under "sparse24" and
      "sparse24_int8" on the phase 4 trace, every GEMM the 2:4 variant,
      every decode step's on the decode tile and every chunk's on the
      prefill tile;
  4a. llama3.2-1b with abft=True on the phase 4 trace: streams bitwise those
      of phase 4, no tile flagged, every decode step's GEMM the ABFT
      variant on the decode tile; a short k = 4 n-gram pass with and without
      ABFT, bitwise equal; the step time against phase 4's;
  5s. each 2:4 run held against the plain path on its cache state (every
      GEMM call at 1e-3 * max|ref|; "sparse24" logits at 1e-3 * max|ref|,
      "sparse24_int8" at half the quantization's own effect), one decode
      step profiled (kernel 1 on the decode tile only, as in phase 5's
      ABFT decode step), identical smoke streams across backends under
      both policies and with abft=True;
  6s. / 6a. grok-1 (the same cut) under "sparse24_int8" (peak memory and
      kept payloads printed, 2 grouped launches per MoE layer, all 2:4),
      and a short f32 pass with abft=True (grouped checksums, no flag,
      streams bitwise those without);
  7s. grok "sparse24_int8" held against the plain path as in 7q; grok-1 and
      kimi-k2 smoke streams across backends under "sparse24_int8" and abft.
The dense cache, Mamba2 and the zamba2 hybrid (ssd_scan, mx_flash_attention):
  3.  (with phase 3) ssd_scan at zamba2's head shape (8 x 80 heads, P = S =
      64, chunk 128; L = 512, a ragged L = 200, bf16) and a hard reset
      (a_log = -50 at one step), mx_flash_attention at zamba2's shared block
      (8 x 32 heads, d = 80, L = 512, causal; f32 and bf16), the llama draft
      forward (32 / 8 heads, d = 64, L = 256) and the cross shape (Lq = 33,
      Lk = 70, non-causal), against the plain versions at phase 3's
      tolerances, each attention check with its CTAs and, in f32, the 3xTF32
      route's bound; a bf16 case where a probability rounded to bf16 would
      show (k = [[0, 0], [1, 0]], v = I, q = [[0.0648, 0]]) equal to the
      plain version exactly; the attention's yardstick is
      torch.nn.functional.scaled_dot_product_attention, the scan has none;
      the scan's rows print its chunk slots and the bound of its TF32 route
      (three TF32 products per product in f32); the f32 attention at
      zamba2's shared block and internvl2's forward (B=2 H=48 Hkv=8 d=128
      L=1088) within twice the plain version's max distance to the softmax
      in f64 (its products once summed in the truncating MMAs stood 3.3x as
      far);
  8.  (before phase 4: no profiler session has run yet) zamba2-2.7b at full
      width (54 Mamba2 layers, d_model 2560, the shared block every 6;
      nothing cut), f32 weights from seed 0: the full forward of
      launch/steps.make_prefill_step on 4 x 512 tokens, 54 ssd_scan and 9
      mx_flash_attention launches required, logits within 1e-3 * max|ref| of
      the plain path; 16 tokens through decode_step from an empty dense
      cache against the forward's logits at 1e-3 * max|ref|; the dense
      continuous batcher on JAX's non-prefix launcher trace (16 requests,
      prompts of 2-128 tokens, 16 new tokens, 8 slots, f32 cache) on the
      kernel and the plain path, equal full-width streams counted; dense
      smoke streams equal across backends (zamba2, and llama dense = paged);
      the static launcher once in its own process; and, last of the run, one
      decode step and one full forward profiled (the attention kernels'
      device time printed, as for phase 5's verify step);
  9.  (before phase 5) llama3.2-1b on the dense cache: a short trace through
      ContinuousBatcher(paged=False) and (paged=True), streams equal (a
      divergence passes only at a near tie); the static launcher with
      --prefill-chunk 64.  The draft-model run of phase 4 must launch
      mx_flash_attention (its full forwards).
The xLSTM, encoder-decoder and prefix-embedding families:
  3.  (with phase 3) mx_flash_attention at seamless-m4t-medium's encoder
      (4 x 16 heads, d = 64, L = 512, non-causal) and cross-attention (Lq =
      64 and Lq = 1 against Lk = 512; f32 and bf16 at Lq = 1) and at
      internvl2-26b's forward (2 x 48 / 8 heads, d = 128, L = 1088 =
      1024 prefix + 64 text, causal; f32 and bf16); the GEMMs at
      xlstm-125m's decode projections (M = 8: K = N = 1536, and 768 x 3072)
      and its forward's (f32, M = 2048: 768 x 3072, 1536 x 1536, 1536 x 768,
      768 x 768), each of these also no more than twice as far from the f64
      product as the plain version;
  10. (after grok is freed; each model freed before the next; every phase's
      seconds printed) xlstm-125m at full width, nothing cut (9 mLSTM + 3
      sLSTM blocks, d_model 768, 4 heads, vocab 50304, tied): the forward on
      4 x 512 tokens, kernel path against plain path at 1e-3 * max|ref|
      and no more than twice as far from the plain path in f64 as the plain
      path (51 mx_matmul_fused launches, all on the prefill tile), 16 decode
      steps against the forward's logits (exactly 51 mx_matmul_fused
      launches a step, all on the decode tile), the dense batcher on JAX's
      non-prefix trace (16 requests, prompts of 2-128 tokens, 16 new, 8
      slots) on both paths, and the static launcher (8 x 64 prompt tokens,
      16 new) in its own process; seamless-m4t-medium at full width, nothing
      cut (12 + 12 layers, d_model 1024, 16 heads of 64, gelu d_ff 4096,
      vocab 256206): the forward on 4 x 512 frames + 4 x 512 tokens against
      the plain path (36 mx_flash_attention launches: 12 encoder, 12 causal
      decoder, 12 cross), 16 decode steps against the encoder output (12
      cross-attention launches a step) against the forward, the static
      launcher; internvl2-26b at full width, its depth cut from 48 to 8
      layers (48 are 79.5 GB in f32): the prefill step on 2 x (1024 prefix
      embeddings of width 3200 + 64 tokens) against the plain path on the
      text positions (8 attention launches), then text only as JAX serves
      it: the static launcher's path in this process (the launcher's
      command line builds all 48 layers) and the dense batcher on both
      paths; and smoke-size streams equal across backends for the three.
Disaggregated serving, chaos and the non-finite quarantine:
  3.  (with phase 3) the decode tile at M = 4 and the paged decode at 4
      slots (phase 11's decode steps);
  11. (after phase 10, before the zamba2 profile) llama3.2-1b at full width
      again (f32, seed 0, nothing cut), every run on "cuda_mx" with its
      launches counted from 0 and required: 11a the disaggregated engine
      (2 prefill workers, 4 decode slots, page size 16, prefill chunk 64) on
      the launcher's --disagg trace at --prompt-len 128 --gen 16 (16
      requests, half sharing a 96-token system prompt) against a plain paged
      batcher run of the same requests, handoffs and pages published
      printed; 11b the same with shared_pool=False, the prefill cache's
      bytes printed first, migrated pages counted as (len(prompt) - 1) // 16
      per request through a worker and each migration bitwise its source
      pages; 11c 11a under the launcher's disagg fault mix at --fault-rate
      0.2 plus a kill, a hang and a drop window forcing a reroute, every
      summary counter printed; 11d the paged batcher on phase 4's trace
      (priorities and deadlines staggered, as the launcher does under
      --chaos) fault-free, with the non-finite guard alone (its cost on the
      median step printed) and with abft=True under the launcher's fault mix
      at --fault-rate 0.1 with bit flips: every flip detected and corrected,
      the quarantined requests exactly the poisoned ones; 11e k = 4 n-gram
      speculation (8 requests, 16 new) fault-free and under the same chaos.
      Token streams: a stream no fault touched equals the fault-free run's;
      a stream that differs (11a / 11b against the plain batcher, a touched
      one under chaos) is printed with its first differing step and the
      reference's top-2 logit gap there, which must be below 1e-3 *
      max|logit| (phase 5's tolerance).
Tensor parallelism, the ring collective GEMMs on one card:
  12. (after phase 11, on its llama3.2-1b weights, before the zamba2 profile)
      every rank of an 8-rank LocalRing on the card, every chunk GEMM kernel
      1: 12a the rings at llama's projections (q / k / v and up+gate on the
      all-gather ring, out and down on the reduce-scatter ring with the
      residual fused; M = 64 and 8, each direction; bf16, and "int8" and
      "int8_all" (its per-row scales riding the ring) all-gathers) against
      their serialized references and one kernel-1 launch on the whole GEMM
      (f32 and quantized 1e-4, bf16 2e-2 * max|ref|), the all-gather chunk
      rows bitwise kernel 1 on the same rows and shard, each timed beside
      its serialized reference, kernel 1 on the whole GEMM and the library
      call, with the whole GEMM's bound and the bytes the hops copy; 12b a
      ring fault per mode under abft: flagged, recovered bitwise the
      fault-free ring, one host read of the flag total per clean ring
      linear; 12c (i) the prefill step on 2 x 256 tokens under
      collective_policy against the step without it (1e-3 * max|ref|), (ii)
      the paged batcher on phase 4's trace cut to 8 requests x 8 new tokens
      under the policy against the same run without it (phase 5's near-tie
      rule), the chunk launches per ring mode and the fallbacks printed; 12d
      the MoE's collective branch at grok-1-smoke's widths against its
      grouped launch, GPipe over 4 stages of one full-width llama layer
      against the layers in sequence.  The multi-GPU ring (NCCL) is not
      measured.
Training, the plain path under autograd (no kernel: JAX trains on "xla"):
  13. (after phase 12, before the zamba2 profile; 13d and 13e in processes
      of their own beside 13a-13c) 13a a "cuda_mx" linear and
      mx_flash_attention refuse an operand that requires grad, nothing
      launched, and under no_grad give the bits of an operand that does
      not; 13b one train step of every smoke config on the card against the
      same step on the CPU (TRAIN_STEP_TOL), no kernel launched, every leaf
      on the card; GPipe's gradient over LocalRing(4) on the card (4
      full-width llama layers) against the layers in sequence (1e-5 *
      max|ref|); 13c llama3.2-1b at full width (f32, seed 0, SyntheticLM
      seed 0, batch 8 x 128): the step-1 gradient against the same in f64
      (loss 1e-5, grad_norm 1e-4, every leaf 1e-3 * max|g64|), microbatch 2
      against 1 (MICROBATCH_TOL), 8 in-place AdamW steps at a constant 3e-4
      without weight decay on the one batch (the loss falls by at least
      0.05), the median step against its bound (6 N T FLOPs at 67 TFLOP/s
      plus AdamW's 7 x 4 N bytes at 3.35 TB/s), tokens/s and the training's
      peak memory (the bound from core/roofline.train_step_bound_s); 13d
      (LOOP_CHILD, deterministic) a TrainLoop with a
      failure at step 6 of 10 bitwise the uninterrupted run, a NaN loss
      raising NanLossError, the last checkpoint restored onto the CPU with
      the card's bits; 13e `python -m repro_torch.launch.train --smoke
      --steps 20 --inject-failure 7` on the card, one restart.  Every
      sub-phase prints its numbers; the phase fails at its end if any
      check failed.
The paper's analytics against kernels 1 and 2 (run after phase 3a, before
any model is served, so its times come before every profiler session):
  14. llama3.2-1b's projections of a paged step (q, k/v, o+residual,
      up+gate swiglu, down+residual) at M = 8 (the decode tile) and M = 64
      (a prefill chunk), f32 and bf16: 14a for each launch of kernel 1 (with
      the step's epilogue) the tile pricer's plan (core/tiling: tile,
      stages, split, parts, shared memory, register accumulator), its
      executed bytes (kernels/quant.launch_gemm_bytes), its FLOPs, its
      device time (operand sets past L2) and the share of its roofline
      bound (core/roofline.bound_ms: each input read once, the output
      written once) it reaches, and the same for kernel 2 on the bare GEMM;
      fails if a plan's shared memory passes SMEM_PER_CTA, a share reads
      above SHARE_LIMIT or a launch's output leaves its plain version's
      tolerance; 14b the paper's A/B: the transfer model's HBM bytes at
      kernel 1's launched tile with and without inter-k buffering (kernel 2
      round-trips every 128 rows of K) beside the measured time of kernel 2
      over kernel 1 on the bare GEMM (fails only if the model's MX bytes are
      not below the baseline's); 14c mx_flash_decode at phase 3's shape
      against PagedKVDecode.paged_step_bytes through kv_decode_memory_s,
      beside phase 3's bound and the bytes between them (fails if the
      kernel's share of the model's bound reads above SHARE_LIMIT).
The dry run against the card (after phase 13, before the zamba2 profile):
  15. the op census (core/op_census.py) of steps run on "meta" tensors
      (launch/specs.py) against the same steps on the card: 15a phase 13c's
      llama3.2-1b train step (full width, 8 x 128, f32, in-place AdamW, the
      "torch" backend): its FLOPs equal FlopCounterMode's on one step on the
      card exactly, and its peak (arguments plus the live peak) over 13c's
      measured peak - held lies in [0.9, 1.1]; 15b the same two checks on
      llama3.2-1b's dense decode step, batch 8 against a 4096-position bf16
      cache, under MXPolicy("torch") (no ctypes launch escapes the counter;
      the peak measured from before the parameters exist); 15c each step's
      RooflineReport bound printed beside its measured time (no gate); 15d
      `python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape
      decode_32k` (a process of its own, beside 15a-15c) prints
      fits_h100_80gb and its peak beside the card's total memory; 15e
      `python examples/torch/quickstart.py` on the card (beside them too),
      its kernel-versus-plain line ok.
Every bound comes from core/roofline.py (`_bound_ms`, the TF32 route's
`_route_bound_ms`).
The line before the last is the kernel summary JSON; the last line is
{"ok": true, "device": {...}}.  Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# FFMAs a prefill kernel may hold outside the ABFT checksums (its epilogue's
# activations): fewer than one K step of the CUDA-core loop the prefill tile
# replaced, whose smallest tile unrolled 128 (2 x 4 outputs per thread, 16 K
# rows)
PREFILL_MAX_FFMA = 127
PREFILL_LIBS = ("mx_matmul", "mx_matmul_sparse", "mx_matmul_abft", "baseline_matmul")
# the grouped GEMM's libraries: their "mma" route (csrc/grouped_mma.cuh) is
# held to the prefill kernels' SASS rule
GROUPED_LIBS = ("mx_grouped_matmul", "mx_grouped_matmul_sparse", "mx_grouped_matmul_abft")
# the grouped GEMM's loop with copies only (no MMAs; wrong results, timing
# only): the weight stream's own rate at grok's decode down projection
GROUPED_COPIES = ("mx_grouped_matmul", ("PREFILL_TIMING_NO_PRODUCTS",))
REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
QUANT_POLICIES = ("int8", "fp8", "int8_all", "fp8_all")  # the quantized operand pairs
L2_BYTES = 50 * 2**20
SPIN_CYCLES_PER_S = 2.0e9  # torch.cuda._sleep cycles per second (H100 SM clock <= 1.98 GHz)
TPU_KERNELS = {  # file:line of the Pallas wrapper each CUDA kernel replaces
    "mx_matmul_fused": "src/repro/kernels/mx_matmul.py:382",
    "baseline_matmul": "src/repro/kernels/baseline_matmul.py:45",
    "mx_flash_decode": "src/repro/kernels/mx_flash_decode.py:108",
    "mx_flash_verify": "src/repro/kernels/mx_flash_decode.py:257",
    "mx_grouped_matmul": "src/repro/kernels/mx_grouped_matmul.py:218",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:68",
    "mx_flash_attention": "src/repro/kernels/mx_flash_attention.py:70",
}
SOURCES = {
    "mx_matmul_fused": "src/repro_torch/csrc/mx_matmul.cu",
    "mx_matmul_fused sparse": "src/repro_torch/csrc/mx_matmul_sparse.cu",
    "mx_matmul_fused abft": "src/repro_torch/csrc/mx_matmul_abft.cu",
    "baseline_matmul": "src/repro_torch/csrc/baseline_matmul.cu",
    "mx_flash_decode": "src/repro_torch/csrc/mx_flash_decode.cu",
    "mx_flash_verify": "src/repro_torch/csrc/mx_flash_decode.cu",
    "mx_grouped_matmul": "src/repro_torch/csrc/mx_grouped_matmul.cu",
    "mx_grouped_matmul sparse": "src/repro_torch/csrc/mx_grouped_matmul_sparse.cu",
    "mx_grouped_matmul abft": "src/repro_torch/csrc/mx_grouped_matmul_abft.cu",
    "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu",
    "mx_flash_attention": "src/repro_torch/csrc/mx_flash_attention.cu",
}


def _bound_ms(nbytes: float, flops: float, dtype: str):
    """(ms, "bytes" or "operations"): `core/roofline.bound_ms`, the larger
    of the bytes at the card's HBM rate and the operations at the type's
    peak (H100 SXM data sheet)."""
    from repro_torch.core.roofline import bound_ms

    return bound_ms(nbytes, flops, dtype)


def _route_bound_ms(nbytes: float, route_flops: float) -> float:
    """The bound of the tensor cores' TF32 route (the f32 kernels' 3xTF32
    products: `route_flops` counts each of the three)"""
    return _bound_ms(nbytes, route_flops, "tf32")[0]


def _host_s(torch, fn, arg_sets, calls=5):
    """Host seconds one call of fn takes to enqueue (after a warm-up)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(*arg_sets[i % len(arg_sets)])
    host = (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return host


def _queue_ahead(torch, host_s):
    """Keep the card busy (a spin kernel) for longer than the host takes to
    enqueue the timed calls, so they run back to back and the events time
    the device, not the Python wrappers' launch overhead."""
    torch.cuda._sleep(int(1.5 * host_s * SPIN_CYCLES_PER_S) + 100_000)


def _time_ms(torch, fns, windows=5, iters=20, warmup=3):
    """Time each `name -> (fn, arg_sets)` of `fns` with CUDA events over
    `windows` windows of `iters` calls, the functions taking turns window by
    window, each call cycling through its `arg_sets` (copies of the inputs
    that together exceed L2, so every call reads cold); each window starts
    behind a spin kernel that outlasts its enqueue.  Returns `ms`,
    `plain_ms` and `library_ms` as the median of the windows' mean ms per
    call (None where `fns` lacks the name) and `windows_ms`, every window's
    mean, as the spread."""
    for fn, arg_sets in fns.values():
        for i in range(warmup):
            fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    host = {name: _host_s(torch, fn, arg_sets) for name, (fn, arg_sets) in fns.items()}
    per = {name: [] for name in fns}
    for _ in range(windows):
        for name, (fn, arg_sets) in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            _queue_ahead(torch, iters * host[name])
            start.record()
            for i in range(iters):
                fn(*arg_sets[i % len(arg_sets)])
            end.record()
            end.synchronize()
            per[name].append(start.elapsed_time(end) / iters)
    out = {k: statistics.median(per[k]) if k in per else None
           for k in ("ms", "plain_ms", "library_ms")}
    out["windows_ms"] = per
    return out


def _spread(c) -> float:
    """The kernel's spread across windows, (max - min) / median."""
    w = c["windows_ms"]["ms"]
    return (max(w) - min(w)) / c["ms"]


def _copies(nbytes: int) -> int:
    return max(1, min(16, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def _err(torch, got, ref, dtype: str):
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    tol = REL_TOL[dtype] * ref.abs().max().item()
    return err, tol


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def _offset(torch, t, nbytes):
    """t copied into a contiguous view whose data starts nbytes past a
    16-byte boundary (0: t itself)."""
    if not nbytes:
        return t
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    v = buf[nbytes // t.element_size():][:t.numel()].view(t.shape)
    v.copy_(t)
    return v


def _decode_tile(a, b, b_gate=None, b_meta=None, bg_meta=None, variant="dense"):
    """The decode tile a launch of `variant` on these operands takes (M <=
    16), as a dict (with the metadata's copy width vm for 2:4)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import mx_matmul as mm

    if a.shape[0] > _build.DECODE_MAX_M:
        return None
    bn, bk, tm, stages, threads, va, vb, *vm = mm.decode_launch_tile(a, b, b_gate, b_meta,
                                                                     bg_meta, variant)
    t = _build.decode_tile(a.shape[0], b.shape[1], a.dtype, b.dtype, b_gate is not None,
                           variant)
    return dict(bn=bn, bk=bk, tm=tm, stages=stages, threads=threads, va=va, vb=vb,
                smem=t.smem, ctas=t.ctas, variant=variant, **dict(zip(("vm",), vm)))


def _prefill_tile(a, b, b_gate=None, variant="dense"):
    """The tensor-core prefill tile a launch on these operands takes (every
    pair, M > 16), as a dict with its route, else None."""
    from repro_torch.kernels import _build

    if a.shape[0] <= _build.DECODE_MAX_M:
        return None
    t = _build.prefill_tile(a.shape[0], b.shape[1], a.shape[1], a.dtype, b.dtype,
                            b_gate is not None, variant)
    return dict(route=t.route, bm=t.bm, bn=t.bn, bk=t.bk, stages=t.stages, split=t.split,
                parts=t.parts, threads=t.threads, smem=t.smem, ctas=t.ctas)


def check_gemm(torch, dev, M, K, N, dtype_name, ep_kw, seed, offset=None, f64=False):
    """mx_matmul_fused against its plain version; `offset` ("a" or "b")
    makes that operand a contiguous view 4 bytes past a 16-byte boundary
    (the decode tile's narrow copies); `f64` (no epilogue) also reads the
    kernel's and the plain version's distance to the f64 product."""
    from repro_torch.kernels import mx_matmul as mm

    dt = getattr(torch, dtype_name)
    ep = mm.Epilogue(**ep_kw)
    g = torch.Generator(device=dev).manual_seed(seed)

    def make():
        a = _offset(torch, torch.randn((M, K), generator=g, device=dev).to(dt),
                    4 if offset == "a" else 0)
        b = _offset(torch, (torch.randn((K, N), generator=g, device=dev) / math.sqrt(K)).to(dt),
                    4 if offset == "b" else 0)
        kw = dict(
            b_gate=(torch.randn((K, N), generator=g, device=dev) / math.sqrt(K)).to(dt)
            if ep.has_gate else None,
            bias=torch.randn((N,), generator=g, device=dev).to(dt) if ep.bias else None,
            residual=torch.randn((M, N), generator=g, device=dev).to(dt)
            if ep.residual else None)
        return a, b, kw

    el = torch.finfo(dt).bits // 8
    nbytes = el * (M * K + K * N * (2 if ep.has_gate else 1) + M * N
                   + (N if ep.bias else 0) + (M * N if ep.residual else 0))
    flops = 2 * M * N * K * (2 if ep.has_gate else 1)
    sets = [make() for _ in range(_copies(nbytes))]
    a, b, kw = sets[0]
    got = mm.mx_matmul_fused(a, b, epilogue=ep, **kw)
    ref = mm.mx_matmul_fused_plain(a, b, epilogue=ep, **kw)
    torch.cuda.synchronize()
    err, tol = _err(torch, got, ref, dtype_name)
    fns = dict(
        ms=(lambda a_, b_, kw_: mm.mx_matmul_fused(a_, b_, epilogue=ep, **kw_), sets),
        plain_ms=(lambda a_, b_, kw_: mm.mx_matmul_fused_plain(a_, b_, epilogue=ep, **kw_),
                  sets))
    # one PyTorch call computes the same function only for A@B (+ bias or
    # residual); no single call computes the swiglu pair
    library = None
    if ep_kw == {}:
        library = "torch.matmul"
        fns["library_ms"] = (lambda a_, b_, kw_: torch.matmul(a_, b_), sets)
    elif set(ep_kw) in ({"bias"}, {"residual"}):
        library = "torch.addmm"
        fns["library_ms"] = (lambda a_, b_, kw_: torch.addmm(
            kw_["bias"] if ep.bias else kw_["residual"], a_, b_), sets)
    bound, by = _bound_ms(nbytes, flops, dtype_name)
    out = dict(kernel="mx_matmul_fused", M=M, K=K, N=N, dtype=dtype_name,
               epilogue=ep_kw, max_abs_err=err, tol=tol, **_time_ms(torch, fns),
               library=library, bound_ms=bound, bound_by=by,
               tile=_decode_tile(a, b, kw["b_gate"]),
               prefill_tile=_prefill_tile(a, b, kw["b_gate"]))
    if out["prefill_tile"] and dtype_name == "float32":
        # the route's own bound: three TF32 products per f32 product
        out["route_bound_ms"] = _route_bound_ms(nbytes, 3 * flops)
    if offset:
        out["offset"] = offset
    if f64:
        exact = torch.matmul(a.double(), b.double())
        out["f64_err"] = (got.double() - exact).abs().max().item()
        out["plain_f64_err"] = (ref.double() - exact).abs().max().item()
    return out


def check_baseline(torch, dev, M, K, N, dtype_name, seed, bk=128):
    from repro_torch.kernels.baseline_matmul import baseline_matmul
    from repro_torch.kernels.ref import baseline_matmul_ref

    dt = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(seed)
    el = torch.finfo(dt).bits // 8
    nbytes = el * (M * K + K * N + M * N)
    sets = [(torch.randn((M, K), generator=g, device=dev).to(dt),
             (torch.randn((K, N), generator=g, device=dev) / math.sqrt(K)).to(dt))
            for _ in range(_copies(nbytes))]
    a, b = sets[0]
    got = baseline_matmul(a, b, bk=bk)
    ref = baseline_matmul_ref(a, b, bk, dt)
    torch.cuda.synchronize()
    err, tol = _err(torch, got, ref, dtype_name)
    times = _time_ms(torch, dict(
        ms=(lambda a_, b_: baseline_matmul(a_, b_, bk=bk), sets),
        plain_ms=(lambda a_, b_: baseline_matmul_ref(a_, b_, bk, dt), sets),
        library_ms=(lambda a_, b_: torch.matmul(a_, b_), sets)))
    bound, by = _bound_ms(nbytes, 2 * M * N * K, dtype_name)
    out = dict(kernel="baseline_matmul", M=M, K=K, N=N, dtype=dtype_name, bk=bk,
               max_abs_err=err, tol=tol, **times, library="torch.matmul",
               bound_ms=bound, bound_by=by, tile=_decode_tile(a, b),
               prefill_tile=_prefill_tile(a, b, variant="baseline"))
    if out["prefill_tile"] and dtype_name == "float32":
        out["route_bound_ms"] = _route_bound_ms(nbytes, 3 * 2 * M * N * K)
    return out


def _attn_inputs(torch, dev, B, H, Hkv, d, ps, lengths, dtype_name, seed, poison, pages,
                 S=None):
    """Copies (together past L2) of q ((B, H, d), or (B, S, H, d) for a
    window) and the page pools over a table that reserves each slot's
    length, plus the table, the lengths and the bytes one call must move.
    pages "same": pools in q's dtype; "int8" / "fp8": payloads quantized per
    row and head as the cache stores them, with f32 scale pages.  poison:
    every non-live row (stale pages, the dump page) is 1e30 -- for quantized
    pages the 1e30 lands in the row's scale."""
    import numpy as np

    from repro_torch.core.precision import QuantSpec
    from repro_torch.kernels.quant import quantize
    from repro_torch.runtime.kv_pages import PagePool

    dt = getattr(torch, dtype_name)
    W = max(1, -(-max(lengths) // ps))
    P = B * W + 1
    pool = PagePool(P - 1, ps)
    for s, ln in enumerate(lengths):
        if ln:
            pool.reserve(s, ln)
            pool.set_length(s, ln)
    table = torch.as_tensor(pool.page_table(B, W), device=dev)
    lns = torch.as_tensor(pool.lengths(B), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    el = torch.finfo(dt).bits // 8
    quantized = pages != "same"
    pel = 1 if quantized else el
    live_rows = sum(lengths)
    rows_q = B * H * d * (S or 1)
    nbytes = (2 * el * rows_q + 2 * pel * live_rows * Hkv * d + 4 * (B * W + B)
              + (2 * 4 * live_rows * Hkv if quantized else 0))
    dead = None
    if poison:
        live = np.zeros((P, ps), bool)
        tb = table.cpu().numpy()
        for s, ln in enumerate(lengths):
            for pos in range(ln):
                live[tb[s, pos // ps], pos % ps] = True
        dead = torch.as_tensor(~live, device=dev)[:, :, None, None]

    def make():
        q = torch.randn((B, H, d) if S is None else (B, S, H, d), generator=g,
                        device=dev).to(dt)
        kp, vp = (torch.randn((P, ps, Hkv, d), generator=g, device=dev) for _ in "kv")
        if dead is not None:
            kp, vp = kp.masked_fill(dead, 1e30), vp.masked_fill(dead, 1e30)
        if not quantized:
            return q, kp.to(dt), vp.to(dt), {}
        spec = QuantSpec({"int8": "int8", "fp8": "fp8_e4m3"}[pages])
        (qk, ks), (qv, vs) = (quantize(t, spec, axis=-1) for t in (kp, vp))
        return q, qk, qv, dict(k_scale=ks[..., 0].contiguous(),
                               v_scale=vs[..., 0].contiguous())

    pool_bytes = P * ps * Hkv * (2 * pel * d + (8 if quantized else 0))
    sets = [make() for _ in range(_copies(pool_bytes))]
    return sets, table, lns, W, nbytes


def _dense_kv(torch, table, k_, v_, G):
    """The library yardstick's input: K/V gathered densely beforehand,
    (B, H, W*ps, d) with the kv heads repeated G times."""
    B, W = table.shape
    _, ps, Hkv, d = k_.shape
    L = W * ps
    k = k_[table.long()].reshape(B, L, Hkv, d).permute(0, 2, 1, 3)
    v = v_[table.long()].reshape(B, L, Hkv, d).permute(0, 2, 1, 3)
    return k.repeat_interleave(G, 1).contiguous(), v.repeat_interleave(G, 1).contiguous()


def _split(torch, B, S, H, Hkv, d, ps, W, q_dtype, pages):
    """The paged attention's launch (kernels/_build.decode_split) as printed
    and recorded beside each decode and verify row."""
    from repro_torch.kernels import _build

    pdt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}.get(pages, q_dtype)
    sp = _build.decode_split(B, S, Hkv, H // Hkv, d, ps, W, pdt, pages != "same")
    return dict(sp._asdict(), span_positions=sp.span_pages * ps)


def check_decode(torch, dev, B, H, Hkv, d, ps, lengths, dtype_name, seed, poison=False,
                 pages="same", label=None):
    import torch.nn.functional as F

    from repro_torch.kernels.mx_flash_decode import mx_flash_decode
    from repro_torch.kernels.ref import paged_decode_ref

    sets, table, lns, W, nbytes = _attn_inputs(torch, dev, B, H, Hkv, d, ps, lengths,
                                               dtype_name, seed, poison, pages)
    flops = 4 * sum(lengths) * H * d
    q, kp, vp, kw = sets[0]
    got = mx_flash_decode(q, kp, vp, table, lns, **kw)
    ref = paged_decode_ref(q, kp, vp, table, lns, **kw)
    torch.cuda.synchronize()
    err, tol = _err(torch, got, ref, dtype_name)
    zero_rows = all(bool(torch.all(got[i] == 0)) for i, ln in enumerate(lengths) if ln == 0)
    finite = bool(torch.isfinite(got).all())
    fns = dict(
        ms=(lambda q_, k_, v_, kw_: mx_flash_decode(q_, k_, v_, table, lns, **kw_), sets),
        plain_ms=(lambda q_, k_, v_, kw_: paged_decode_ref(q_, k_, v_, table, lns, **kw_),
                  sets))
    library = None
    if pages == "same":  # no single call dequantizes int8 / fp8 pages
        # library yardstick: SDPA over the same rows gathered densely beforehand
        library = "F.scaled_dot_product_attention on pre-gathered dense K/V"
        mask = (torch.arange(W * ps, device=dev)[None, :] < lns[:, None])[:, None, None, :]
        fns["library_ms"] = (lambda q_, k_, v_: F.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=mask), [(q_[:, :, None, :], *_dense_kv(
                torch, table, k_, v_, H // Hkv)) for q_, k_, v_, _ in sets])
    bound, by = _bound_ms(nbytes, flops, dtype_name)
    split = _split(torch, B, 1, H, Hkv, d, ps, W, getattr(torch, dtype_name), pages)
    return dict(kernel="mx_flash_decode", label=label, B=B, H=H, Hkv=Hkv, d=d, ps=ps,
                lengths=list(lengths), poison=poison, pages=pages, dtype=dtype_name,
                max_abs_err=err, tol=tol, zero_rows_exact=zero_rows, finite=finite,
                **_time_ms(torch, fns), library=library, bound_ms=bound, bound_by=by,
                split=split, bytes=nbytes)


def check_verify(torch, dev, B, H, Hkv, d, ps, S, lengths, dtype_name, seed, poison=False,
                 pages="same"):
    """mx_flash_verify against paged_verify_ref; at S = 1 also against the
    decode kernel on the same inputs, bitwise."""
    import torch.nn.functional as F

    from repro_torch.kernels.mx_flash_decode import mx_flash_decode, mx_flash_verify
    from repro_torch.kernels.ref import paged_verify_ref

    sets, table, lns, W, nbytes = _attn_inputs(torch, dev, B, H, Hkv, d, ps, lengths,
                                               dtype_name, seed, poison, pages, S=S)
    # each window row r sees positions <= len - S + r
    flops = 4 * H * d * sum(max(0, ln - S + r + 1) for ln in lengths if ln
                            for r in range(S))
    q, kp, vp, kw = sets[0]
    got = mx_flash_verify(q, kp, vp, table, lns, **kw)
    ref = paged_verify_ref(q, kp, vp, table, lns, **kw)
    torch.cuda.synchronize()
    err, tol = _err(torch, got, ref, dtype_name)
    out = dict(zero_rows_exact=all(bool(torch.all(got[i] == 0))
                                   for i, ln in enumerate(lengths) if ln == 0),
               finite=bool(torch.isfinite(got).all()))
    if S == 1:
        dec = mx_flash_decode(q[:, 0].contiguous(), kp, vp, table, lns, **kw)
        torch.cuda.synchronize()
        out.update(decode_err=(got[:, 0].float() - dec.float()).abs().max().item(),
                   decode_tol=1e-6 * dec.float().abs().max().item(),
                   decode_bitwise=bool(torch.equal(got[:, 0], dec)))
    fns = dict(
        ms=(lambda q_, k_, v_, kw_: mx_flash_verify(q_, k_, v_, table, lns, **kw_), sets),
        plain_ms=(lambda q_, k_, v_, kw_: paged_verify_ref(q_, k_, v_, table, lns, **kw_),
                  sets))
    library = None
    if pages == "same":
        library = "F.scaled_dot_product_attention on pre-gathered dense K/V, window mask"
        kpos = torch.arange(W * ps, device=dev)
        last = (lns - S)[:, None] + torch.arange(S, device=dev)  # (B, S)
        mask = (kpos[None, None, :] <= last[:, :, None])[:, None]  # (B, 1, S, L)
        fns["library_ms"] = (lambda q_, k_, v_: F.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=mask), [(q_.transpose(1, 2), *_dense_kv(
                torch, table, k_, v_, H // Hkv)) for q_, k_, v_, _ in sets])
    bound, by = _bound_ms(nbytes, flops, dtype_name)
    split = _split(torch, B, S, H, Hkv, d, ps, W, getattr(torch, dtype_name), pages)
    return dict(kernel="mx_flash_verify", B=B, S=S, H=H, Hkv=Hkv, d=d, ps=ps,
                lengths=list(lengths), poison=poison, pages=pages, dtype=dtype_name,
                max_abs_err=err, tol=tol, **out, **_time_ms(torch, fns),
                library=library, bound_ms=bound, bound_by=by, split=split, bytes=nbytes)


def _expert_stack(torch, dev, G, K, N, dt, gen):
    """(G, K, N) expert weights of std 1/sqrt(K), drawn expert by expert in
    `dt` (no f32 copy of a stack of up to 12.9 GB)."""
    w = torch.empty((G, K, N), dtype=dt, device=dev)
    for g in range(G):
        w[g].normal_(generator=gen).mul_(K ** -0.5)
    return w


def _grouped_tile(x, w, w_gate=None, variant="dense"):
    """The grouped launch's route and tile (`_build.grouped_tile`), printed
    beside its time."""
    from repro_torch.kernels import _build

    T, K = x.shape
    G, _, N = w.shape
    return _build.grouped_tile(T, N, K, G, x.dtype, w.dtype, w_gate is not None,
                               variant)._asdict()


def _grouped_copies(torch, x, w, gs, out):
    """A launch of the grouped GEMM's copies-only variant (GROUPED_COPIES)
    at the tile the package launches: the ring's copies and the group walk
    without the MMAs (wrong results, timing only)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mx_grouped_matmul import _LAUNCHERS, launch_tile

    T, K = x.shape
    G, _, N = w.shape
    route, tile = launch_tile(x, w)
    src, sym, argtypes = _LAUNCHERS["dense", route]
    fn = _build.function(src, sym, argtypes, defines=GROUPED_COPIES[1])
    dt = _build.FLOATS + _build.QUANTIZED
    args = (x.data_ptr(), w.data_ptr(), None, None, None, None, gs.data_ptr(),
            out.data_ptr(), _build.dtype_code(out.dtype, "out"), T, N, K, G,
            _build.dtype_code(x.dtype, "x", dt), _build.dtype_code(w.dtype, "w", dt), 0,
            *tile, _build.stream_ptr(x))

    def run():
        _build.check(fn(*args), src, "the grouped copies-only variant")
    return run


def check_grouped(torch, dev, label, T, sizes, K, N, dtype_name, act, seed, w=None):
    """mx_grouped_matmul against grouped_matmul_ref; rows no group owns must
    be exact zeros.  The bound counts x's owned rows, the weights of the
    groups that own rows and the output once each; every stack here is
    past L2, so each call reads its weights cold."""
    from repro_torch.kernels.mx_grouped_matmul import mx_grouped_matmul
    from repro_torch.kernels.ref import grouped_matmul_ref

    dt = getattr(torch, dtype_name)
    G = len(sizes)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((T, K), generator=gen, device=dev).to(dt)
    w = _expert_stack(torch, dev, G, K, N, dt, gen) if w is None else w
    wg = _expert_stack(torch, dev, G, K, N, dt, gen) if act == "swiglu" else None
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    got = mx_grouped_matmul(x, w, gs, w_gate=wg, activation=act)
    ref = grouped_matmul_ref(x, w, gs, w_gate=wg, activation=act)
    torch.cuda.synchronize()
    err, tol = _err(torch, got, ref, dtype_name)
    owned, start = [], 0  # each group's rows, clamped to T as the kernel reads them
    for n in sizes:
        end = min(start + n, T)
        owned.append(end - start)
        start = end
    rows, live = sum(owned), sum(1 for n in owned if n)
    nmat = 2 if act == "swiglu" else 1
    el = torch.finfo(dt).bits // 8
    nbytes = el * (rows * K + nmat * live * K * N + T * N)
    fns = dict(ms=(lambda: mx_grouped_matmul(x, w, gs, w_gate=wg, activation=act), [()]),
               plain_ms=(lambda: grouped_matmul_ref(x, w, gs, w_gate=wg, activation=act),
                         [()]))
    library, extra = None, {}
    if act == "none" and len(set(sizes)) == 1 and rows == T:
        library = "torch.bmm over (E, C, K) x (E, K, N)"
        xe = x.view(G, T // G, K)
        fns["library_ms"] = (lambda: torch.bmm(xe, w), [()])
    elif dt == torch.bfloat16 and len(set(sizes)) > 1:  # ragged: one grouped call
        library = "torch._grouped_mm over the groups' row offsets (x @ w[g] only)"
        offs = torch.tensor(list(itertools.accumulate(owned)), dtype=torch.int32, device=dev)

        def lib():
            return torch._grouped_mm(x, w, offs=offs, out_dtype=torch.bfloat16)
        try:
            extra["library_err"] = (lib()[:rows].float() - ref[:rows].float()).abs().max().item()
            fns["library_ms"] = (lib, [()])
        except Exception as e:  # the card's torch refuses it
            library = None
            extra["library_error"] = f"{type(e).__name__}: {str(e)[:160]}"
    copies = label == "grok decode down"
    if copies:  # the weight stream's rate without the MMAs
        fns["copies_ms"] = (_grouped_copies(torch, x, w, gs, torch.empty_like(got)), [()])
    bound, by = _bound_ms(nbytes, 2 * rows * K * N * nmat, dtype_name)
    times = _time_ms(torch, fns, iters=5)
    if copies:
        extra["copies_ms"] = statistics.median(times["windows_ms"]["copies_ms"])
        extra["copies_tb_s"] = nbytes / extra["copies_ms"] / 1e9
    return dict(kernel="mx_grouped_matmul", label=label, T=T, G=G, K=K, N=N, act=act,
                dtype=dtype_name, live_groups=live, rows=rows, max_abs_err=err, tol=tol,
                zero_rows_exact=bool(torch.all(got[rows:] == 0)),
                finite=bool(torch.isfinite(got).all()), **times, **extra,
                library=library, bound_ms=bound, bound_by=by, tb_s=nbytes / times["ms"] / 1e9,
                grouped_tile=_grouped_tile(x, w, wg))


def grouped_checks(torch, dev):
    """Grok-1's expert GEMMs at full width, ragged edge cases, kimi-k2's 384
    experts (bf16, offsets past 2^31)."""
    checks = []
    ragged = [  # (label, T, sizes, act): T/K/N off every tile
        ("ragged, empty groups, tail", 70, [0, 13, 0, 0, 40, 3, 0, 7], "swiglu"),
        ("tile straddles 4 groups", 70, [2, 3, 1, 0, 9, 20, 0, 35], "gelu"),
        ("oversubscribed, sum 90 > T", 70, [50, 40], "silu"),
        ("sum 128 < T, big tile", 200, [64, 0, 64], "relu"),
    ]
    for dtype_name in ("float32", "bfloat16"):
        for label, T, C, K, N, act in (
                ("grok decode up+gate", 64, 8, 6144, 32768, "swiglu"),
                ("grok decode down", 64, 8, 32768, 6144, "none"),
                ("grok prefill up+gate", 1024, 128, 6144, 32768, "swiglu"),
                ("grok prefill down", 1024, 128, 32768, 6144, "none")):
            checks.append(check_grouped(torch, dev, label, T, [C] * 8, K, N, dtype_name,
                                        act, 200 + len(checks)))
        for label, T, sizes, act in ragged:
            checks.append(check_grouped(torch, dev, label, T, sizes, 6100, 2050,
                                        dtype_name, act, 200 + len(checks)))
    gen = torch.Generator(device=dev).manual_seed(300)
    w = _expert_stack(torch, dev, 384, 7168, 2048, torch.bfloat16, gen)
    for label, sizes in (("kimi decode, 384 x 8", [8] * 384),
                         ("kimi ragged, 48 of 384 live", [64 if g % 8 == 7 else 0
                                                          for g in range(384)])):
        checks.append(check_grouped(torch, dev, label, 3072, sizes, 7168, 2048, "bfloat16",
                                    "none", 301 + len(checks), w=w))
    return checks


def _peak_type(a, b) -> str:
    """The peak rate a pair's operations are priced at: the payload type
    when both operands share it, else bf16 (the narrow weight widens to the
    activation's type)."""
    if a.dtype == b.dtype:
        return str(a.dtype).removeprefix("torch.")
    return "bfloat16"


def check_quant_gemm(torch, dev, pol, M, K, N, ep_kw, seed):
    """mx_matmul_fused on the payloads and scales of named policy `pol`
    against mx_matmul_fused_plain on the same ones (f32 output, within
    1e-4 * max|ref|; "int8_all" with scales only must be bitwise).  The
    bound counts the payloads at their own bytes plus the f32 scales.  The
    library yardstick, where one call's shape rules allow it: torch._int_mm
    (the int32 product, scales left out) for int8 x int8, torch._scaled_mm
    with row-wise scales (bf16 output) for fp8 x fp8, with its error.  An
    fp8 x fp8 launch of more than 16 rows with scales only also reads its
    distance, and the plain
    version's, to the f64 product of the same payloads and scales (relative
    RMS; the kernel's may be at most twice the plain version's)."""
    from repro_torch.core.precision import NAMED_POLICIES
    from repro_torch.kernels import mx_matmul as mm
    from repro_torch.kernels.quant import quantize_operand

    P = NAMED_POLICIES[pol]
    g = torch.Generator(device=dev).manual_seed(seed)
    gated = ep_kw.get("activation") == "swiglu"

    def make():
        x = torch.randn((M, K), generator=g, device=dev)
        qa, a_s = quantize_operand(x, P.a, "a")
        qb, b_s = quantize_operand(torch.randn((K, N), generator=g, device=dev) / math.sqrt(K),
                                   P.b, "b")
        qg = bg_s = None
        if gated:
            qg, bg_s = quantize_operand(
                torch.randn((K, N), generator=g, device=dev) / math.sqrt(K), P.b, "b")
        kw = dict(b_gate=qg, a_scale=a_s, b_scale=b_s, bg_scale=bg_s,
                  bias=torch.randn((N,), generator=g, device=dev) if ep_kw.get("bias") else None,
                  residual=torch.randn((M, N), generator=g, device=dev)
                  if ep_kw.get("residual") else None, out_dtype=torch.float32)
        return qa.contiguous(), qb, kw

    nmat = 2 if gated else 1
    a0, b0, kw0 = make()
    ep = mm.Epilogue(**ep_kw, a_scale=kw0["a_scale"] is not None,
                     b_scale=kw0["b_scale"] is not None)
    nbytes = (a0.element_size() * M * K + nmat * b0.element_size() * K * N + 4 * M * N
              + (4 * M if ep.a_scale else 0) + (4 * nmat * N if ep.b_scale else 0)
              + (4 * N if ep.bias else 0) + (4 * M * N if ep.residual else 0))
    sets = [(a0, b0, kw0)] + [make() for _ in range(_copies(nbytes) - 1)]
    got = mm.mx_matmul_fused(a0, b0, epilogue=ep, **kw0)
    ref = mm.mx_matmul_fused_plain(a0, b0, epilogue=ep, **kw0)
    torch.cuda.synchronize()
    err, tol = _err(torch, got, ref, "float32")
    out = dict(finite=bool(torch.isfinite(got).all()))
    if pol == "int8_all" and not ep_kw:
        out["bitwise"] = bool(torch.equal(got, ref))
    if pol == "fp8_all" and not ep_kw and M > 16:  # the 8-bit tensor-core tile
        r64 = (a0.double() * kw0["a_scale"].double()) @ (b0.double() * kw0["b_scale"].double())

        def rel_rms(y):
            return ((y.double() - r64).pow(2).mean() / r64.pow(2).mean()).sqrt().item()
        out["f64_err"], out["plain_f64_err"] = rel_rms(got), rel_rms(ref)
        del r64
    fns = dict(
        ms=(lambda a_, b_, kw_: mm.mx_matmul_fused(a_, b_, epilogue=ep, **kw_), sets),
        plain_ms=(lambda a_, b_, kw_: mm.mx_matmul_fused_plain(a_, b_, epilogue=ep, **kw_),
                  sets))
    library = None
    if not ep_kw and M > 16 and pol == "int8_all":
        library = "torch._int_mm (int32 product; scales left out)"
        fns["library_ms"] = (lambda a_, b_, kw_: torch._int_mm(a_, b_), sets)
    elif not ep_kw and pol == "int8":
        # bf16 activations x an int8 weight with per-column scales, bf16 out
        library = "torch._weight_int8pack_mm (bf16 x int8, per-column scales)"
        cm = [(a_, b_.t().contiguous(), dict(kw_, sc=kw_["b_scale"].reshape(-1).to(a_.dtype)))
              for a_, b_, kw_ in sets]
        try:
            lib = torch._weight_int8pack_mm(cm[0][0], cm[0][1], cm[0][2]["sc"])
            fns["library_ms"] = (lambda a_, b_, kw_: torch._weight_int8pack_mm(
                a_, b_, kw_["sc"]), cm)
            out["library_err"] = (lib.float() - ref).abs().max().item()
        except Exception as e:  # the card's torch refuses it
            library = None
            out["library_error"] = f"{type(e).__name__}: {str(e)[:160]}"
    elif not ep_kw and M % 16 == 0 and pol == "fp8_all":
        library = "torch._scaled_mm, row-wise scales, bf16 output"
        cm = [(a_, b_.t().contiguous().t(), kw_) for a_, b_, kw_ in sets]
        fns["library_ms"] = (lambda a_, b_, kw_: torch._scaled_mm(
            a_, b_, scale_a=kw_["a_scale"], scale_b=kw_["b_scale"],
            out_dtype=torch.bfloat16), cm)
        lib = fns["library_ms"][0](*cm[0])
        out["library_err"] = (lib.float() - ref).abs().max().item()
    bound, by = _bound_ms(nbytes, 2 * M * N * K * nmat, _peak_type(a0, b0))
    return dict(kernel="mx_matmul_fused", M=M, K=K, N=N, dtype=pol,
                pair=f"{a0.dtype} x {b0.dtype}", epilogue=ep_kw, max_abs_err=err, tol=tol,
                **out, **_time_ms(torch, fns), library=library, bound_ms=bound, bound_by=by,
                tile=_decode_tile(a0, b0, kw0["b_gate"]),
                prefill_tile=_prefill_tile(a0, b0, kw0["b_gate"]))


def check_quant_grouped(torch, dev, pol, label, T, C, K, N, act, seed):
    """mx_grouped_matmul on grok's expert widths with named policy `pol`'s
    payloads and per-expert scales, against grouped_matmul_ref (f32 output,
    1e-4 * max|ref|; "int8_all" without activation bitwise).  Each expert
    is drawn in f32 and quantized on its own (per-column scales are per
    expert), so no f32 stack is held."""
    from repro_torch.core.precision import NAMED_POLICIES
    from repro_torch.kernels.mx_grouped_matmul import mx_grouped_matmul
    from repro_torch.kernels.quant import quantize_operand
    from repro_torch.kernels.ref import grouped_matmul_ref

    P = NAMED_POLICIES[pol]
    G = T // C
    gen = torch.Generator(device=dev).manual_seed(seed)
    qx, a_s = quantize_operand(torch.randn((T, K), generator=gen, device=dev), P.a, "a")
    qx = qx.contiguous()

    def stack():
        q = torch.empty((G, K, N), dtype=P.b.torch_dtype, device=dev)
        sc = torch.empty((G, 1, N), device=dev)
        for e in range(G):
            q[e], sc[e] = quantize_operand(
                torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K), P.b, "b")
        return q, sc

    w, b_s = stack()
    wg, bg_s = stack() if act == "swiglu" else (None, None)
    gs = torch.full((G,), C, dtype=torch.int32, device=dev)
    kw = dict(w_gate=wg, activation=act, a_scale=a_s, b_scale=b_s, bg_scale=bg_s,
              out_dtype=torch.float32)
    got = mx_grouped_matmul(qx, w, gs, **kw)
    ref = grouped_matmul_ref(qx, w, gs, **kw)
    torch.cuda.synchronize()
    err, tol = _err(torch, got, ref, "float32")
    out = dict(finite=bool(torch.isfinite(got).all()))
    if pol == "int8_all" and act == "none":
        out["bitwise"] = bool(torch.equal(got, ref))
    nmat = 2 if act == "swiglu" else 1
    nbytes = (qx.element_size() * T * K + nmat * w.element_size() * G * K * N + 4 * T * N
              + (4 * T if a_s is not None else 0) + 4 * nmat * G * N)
    fns = dict(ms=(lambda: mx_grouped_matmul(qx, w, gs, **kw), [()]),
               plain_ms=(lambda: grouped_matmul_ref(qx, w, gs, **kw), [()]))
    library = None
    if pol == "fp8_all" and act == "none":  # the fp8 grouped GEMM, row-wise scales
        library = "torch._scaled_grouped_mm, row-wise scales, bf16 output"
        wt = w.transpose(-2, -1).contiguous().transpose(-2, -1)  # column-major experts
        offs = torch.cumsum(gs, 0).to(torch.int32)
        sa, sb = a_s.reshape(-1).contiguous(), b_s.reshape(G, N).contiguous()

        def lib():
            return torch._scaled_grouped_mm(qx, wt, sa, sb, offs=offs,
                                            out_dtype=torch.bfloat16)
        try:
            out["library_err"] = (lib().float() - ref).abs().max().item()
            fns["library_ms"] = (lib, [()])
        except Exception as e:  # the card's torch refuses it
            library = None
            out["library_error"] = f"{type(e).__name__}: {str(e)[:160]}"
    bound, by = _bound_ms(nbytes, 2 * T * K * N * nmat, _peak_type(qx, w))
    times = _time_ms(torch, fns, iters=5)
    return dict(kernel="mx_grouped_matmul", label=label, T=T, G=G, K=K, N=N, act=act,
                dtype=pol, pair=f"{qx.dtype} x {w.dtype}", max_abs_err=err, tol=tol,
                zero_rows_exact=True, **out, **times, library=library, bound_ms=bound,
                bound_by=by, tb_s=nbytes / times["ms"] / 1e9,
                grouped_tile=_grouped_tile(qx, w, wg))


def quant_checks(torch, dev):
    """Stage 1b / 5b: every quantized operand pair at llama's decode and
    prefill-chunk widths (dense) and grok's expert widths (grouped)."""
    checks, seed = [], 400
    for pol in QUANT_POLICIES:
        for M in (8, 64):  # decode slots, a prefill chunk
            for K, N, ep in ((2048, 8192, dict(activation="swiglu")),
                             (8192, 2048, dict(residual=True))):
                seed += 1
                checks.append(check_quant_gemm(torch, dev, pol, M, K, N, ep, seed))
            if pol.endswith("_all"):  # scales only: bitwise for int8, library yardstick
                seed += 1
                checks.append(check_quant_gemm(torch, dev, pol, M, 2048, 8192, {}, seed))
            if pol == "int8":  # the down projection bare: torch._weight_int8pack_mm
                seed += 1
                checks.append(check_quant_gemm(torch, dev, pol, M, 8192, 2048, {}, seed))
        for M in (1, 16):  # the decode tile's other row counts
            seed += 1
            checks.append(check_quant_gemm(torch, dev, pol, M, 8192, 2048,
                                           dict(residual=True), seed))
    for pol in QUANT_POLICIES:
        for label, T, C, K, N, act in (
                ("grok decode up+gate", 64, 8, 6144, 32768, "swiglu"),
                ("grok decode down", 64, 8, 32768, 6144, "none"),
                ("grok prefill up+gate", 1024, 128, 6144, 32768, "swiglu"),
                ("grok prefill down", 1024, 128, 32768, 6144, "none")):
            seed += 1
            checks.append(check_quant_grouped(torch, dev, pol, label, T, C, K, N, act, seed))
            gc.collect()
            torch.cuda.empty_cache()
    return checks


SPARSE_POLICIES = {  # the pairs of the 2:4 kernels: (name, activation dtype, weight spec)
    "sparse24 f32": ("float32", "f32"), "sparse24 bf16": ("bfloat16", "bf16"),
    "sparse24_int8": ("bfloat16", "int8"),
}


def _sparse_operands(torch, dev, pol, M, K, N, gated, gen, G=None):
    """Activations and 2:4 weights of one sparse pair as ops prepares them:
    the weight drawn in f32 (one expert at a time for a stack), pruned,
    quantized / cast, compressed; returns a, and per weight (payload,
    scale, meta)."""
    from repro_torch.core import ops
    from repro_torch.core.precision import QuantSpec

    adt, wspec = SPARSE_POLICIES[pol]
    spec = QuantSpec(wspec)
    a = torch.randn((M, K), generator=gen, device=dev).to(getattr(torch, adt))

    def weight():
        if G is None:
            return ops._sparse_operand(
                torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K), spec)
        parts = [ops._sparse_operand(torch.randn((K, N), generator=gen, device=dev)
                                     / math.sqrt(K), spec) for _ in range(G)]
        return tuple(None if p[0] is None else torch.stack(p) for p in zip(*parts))

    return a.contiguous(), weight(), weight() if gated else (None, None, None)


def check_sparse_gemm(torch, dev, pol, M, K, N, ep_kw, seed):
    """Stage 1c: mx_matmul_fused on 2:4 operands against the plain version
    (phase 3's tolerance for the output dtype) and BITWISE against the
    dense kernel on expand_24(payload, meta).  The bound counts the payload
    and metadata bytes (`sparse_b_bytes_per_elem`); the library yardstick
    is one torch.sparse semi-structured product on the bf16 weight, its
    sparsity along K, where the card's torch takes it."""
    from repro_torch.kernels import mx_matmul as mm
    from repro_torch.kernels.sparse import expand_24, sparse_b_bytes_per_elem

    g = torch.Generator(device=dev).manual_seed(seed)
    gated = ep_kw.get("activation") == "swiglu"
    a, (qb, bs, bm_), (qg, gs, gm_) = _sparse_operands(torch, dev, pol, M, K, N, gated, g)
    out_dtype = torch.float32 if qb.dtype == torch.int8 else a.dtype
    ep = mm.Epilogue(**ep_kw, b_scale=bs is not None)
    kw = dict(epilogue=ep, b_gate=qg, b_scale=bs, bg_scale=gs,
              bias=torch.randn((N,), generator=g, device=dev).to(out_dtype)
              if ep.bias else None,
              residual=torch.randn((M, N), generator=g, device=dev).to(out_dtype)
              if ep.residual else None, out_dtype=out_dtype)
    skw = dict(kw, b_sparse=True, b_meta=bm_, bg_meta=gm_)
    got = mm.mx_matmul_fused(a, qb, **skw)
    ref = mm.mx_matmul_fused_plain(a, qb, b_meta=bm_, bg_meta=gm_, **kw)
    dense_b = expand_24(qb, bm_)
    dense_g = expand_24(qg, gm_) if gated else None
    dense = mm.mx_matmul_fused(a, dense_b, **dict(kw, b_gate=dense_g))
    torch.cuda.synchronize()
    err, tol = _err(torch, got, ref, "float32" if out_dtype == torch.float32 else "bfloat16")
    nmat = 2 if gated else 1
    wbytes = nmat * K * N * sparse_b_bytes_per_elem(qb.element_size())
    osz = torch.finfo(out_dtype).bits // 8
    nbytes = (a.element_size() * M * K + wbytes + osz * M * N
              + (4 * nmat * N if bs is not None else 0)
              + (osz * N if ep.bias else 0) + (osz * M * N if ep.residual else 0))
    fns = dict(ms=(lambda: mm.mx_matmul_fused(a, qb, **skw), [()]),
               plain_ms=(lambda: mm.mx_matmul_fused_plain(a, qb, b_meta=bm_, bg_meta=gm_, **kw),
                         [()]),
               dense_ms=(lambda: mm.mx_matmul_fused(a, dense_b, **dict(kw, b_gate=dense_g)),
                         [()]))
    library, lib_error = None, None
    if not ep_kw:
        try:  # (N, K) weight, 2:4 along its last axis: y^T = W^T x^T (int8: scales left out)
            from torch.sparse import to_sparse_semi_structured
            wt = to_sparse_semi_structured(dense_b.t().contiguous().to(torch.bfloat16))
            at = a.to(torch.bfloat16).t().contiguous()
            torch.mm(wt, at)
            fns["library_ms"] = (lambda: torch.mm(wt, at), [()])
            library = "torch.sparse.to_sparse_semi_structured (bf16 weight) @ x^T"
        except Exception as e:  # the card's torch refuses this shape or dtype
            lib_error = f"{type(e).__name__}: {str(e)[:160]}"
    times = _time_ms(torch, fns, windows=3, iters=10)
    times["dense_kernel_ms"] = statistics.median(times["windows_ms"]["dense_ms"])
    bound, by = _bound_ms(nbytes, 2 * M * N * K * nmat, _peak_type(a, qb))
    return dict(kernel="mx_matmul_fused", variant="sparse", M=M, K=K, N=N, dtype=pol,
                pair=f"{a.dtype} x {qb.dtype}", epilogue=ep_kw, max_abs_err=err, tol=tol,
                bitwise_vs_dense=bool(torch.equal(got, dense)),
                finite=bool(torch.isfinite(got).all()), **times, library=library,
                library_error=lib_error, bound_ms=bound, bound_by=by, weight_bytes=wbytes,
                tile=_decode_tile(a, qb, qg, bm_, gm_, "sparse"),
                prefill_tile=_prefill_tile(a, qb, qg, "sparse"))


def check_sparse_grouped(torch, dev, pol, label, T, sizes, K, N, act, seed):
    """Stage 5c: mx_grouped_matmul on per-expert 2:4 operands against
    grouped_matmul_ref, and bitwise against the dense grouped kernel on the
    expanded stack; rows no group owns exactly zero."""
    from repro_torch.kernels.mx_grouped_matmul import mx_grouped_matmul
    from repro_torch.kernels.ref import grouped_matmul_ref
    from repro_torch.kernels.sparse import expand_24, sparse_b_bytes_per_elem

    G = len(sizes)
    gen = torch.Generator(device=dev).manual_seed(seed)
    gated = act == "swiglu"
    x, (w, bs, wm), (wg, gs, gm_) = _sparse_operands(torch, dev, pol, T, K, N, gated, gen, G)
    out_dtype = torch.float32 if w.dtype == torch.int8 else x.dtype
    sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
    kw = dict(w_gate=wg, activation=act, b_scale=bs, bg_scale=gs, out_dtype=out_dtype)
    got = mx_grouped_matmul(x, w, sz, b_sparse=True, w_meta=wm, wg_meta=gm_, **kw)
    ref = grouped_matmul_ref(x, w, sz, w_meta=wm, wg_meta=gm_, **kw)
    wd, wgd = expand_24(w, wm), expand_24(wg, gm_) if gated else None
    dense = mx_grouped_matmul(x, wd, sz, **dict(kw, w_gate=wgd))
    torch.cuda.synchronize()
    err, tol = _err(torch, got, ref, "float32" if out_dtype == torch.float32 else "bfloat16")
    owned, start = [], 0
    for n in sizes:
        end = min(start + n, T)
        owned.append(end - start)
        start = end
    rows, live = sum(owned), sum(1 for n in owned if n)
    nmat = 2 if gated else 1
    osz = torch.finfo(out_dtype).bits // 8
    wbytes = nmat * live * K * N * sparse_b_bytes_per_elem(w.element_size())
    nbytes = x.element_size() * rows * K + wbytes + osz * T * N
    fns = dict(ms=(lambda: mx_grouped_matmul(x, w, sz, b_sparse=True, w_meta=wm,
                                             wg_meta=gm_, **kw), [()]),
               plain_ms=(lambda: grouped_matmul_ref(x, w, sz, w_meta=wm, wg_meta=gm_, **kw),
                         [()]),
               dense_ms=(lambda: mx_grouped_matmul(x, wd, sz, **dict(kw, w_gate=wgd)), [()]))
    bound, by = _bound_ms(nbytes, 2 * rows * K * N * nmat, _peak_type(x, w))
    times = _time_ms(torch, fns, windows=3, iters=5)
    times["dense_kernel_ms"] = statistics.median(times["windows_ms"]["dense_ms"])
    return dict(kernel="mx_grouped_matmul", variant="sparse", label=label, T=T, G=G, K=K,
                N=N, act=act, dtype=pol, pair=f"{x.dtype} x {w.dtype}", max_abs_err=err,
                tol=tol, bitwise_vs_dense=bool(torch.equal(got, dense)),
                zero_rows_exact=bool(torch.all(got[rows:] == 0)),
                finite=bool(torch.isfinite(got).all()), **times,
                library=None, bound_ms=bound, bound_by=by, weight_bytes=wbytes,
                tb_s=nbytes / times["ms"] / 1e9,
                grouped_tile=_grouped_tile(x, w, wg if gated else None, "sparse"))


def sparse_checks(torch, dev):
    """Phase 3s: both GEMMs on every sparse pair at llama's decode and
    64-row chunk widths, qwen2's ragged widths and grok's expert widths."""
    checks, seed = [], 600
    for pol in SPARSE_POLICIES:
        for M in (8, 64):
            for K, N, ep in ((2048, 8192, dict(activation="swiglu")),
                             (8192, 2048, dict(residual=True)), (8192, 2048, {})):
                seed += 1
                checks.append(check_sparse_gemm(torch, dev, pol, M, K, N, ep, seed))
        for M, K, N, ep in ((8, 896, 128, dict(bias=True)), (64, 4864, 896, dict(residual=True))):
            seed += 1
            checks.append(check_sparse_gemm(torch, dev, pol, M, K, N, ep, seed))
        for label, T, sizes, K, N, act in (
                ("grok decode up+gate", 64, [8] * 8, 6144, 32768, "swiglu"),
                ("grok decode down", 64, [8] * 8, 32768, 6144, "none"),
                ("grok prefill up+gate", 1024, [128] * 8, 6144, 32768, "swiglu"),
                ("ragged, empty groups, straddles", 70, [0, 13, 0, 0, 40, 3, 0, 7], 6096,
                 2050, "swiglu")):
            seed += 1
            checks.append(check_sparse_grouped(torch, dev, pol, label, T, sizes, K, N, act,
                                               seed))
            gc.collect()
            torch.cuda.empty_cache()
    return checks


def _dense_pair(torch, dev, pol, M, K, N, gated, gen, G=None):
    """Operands of one ABFT pair: a dense named policy's payloads and
    scales, or a sparse policy's expanded (dense-masked) weight, as ops
    hands them to the checksummed launch.  Returns (a, a_scale, (b, b_s),
    (g, g_s))."""
    from repro_torch.core.precision import NAMED_POLICIES
    from repro_torch.kernels.quant import quantize_operand
    from repro_torch.kernels.sparse import expand_24

    if pol in SPARSE_POLICIES:
        a, (qb, bs, bmeta), (qg, gs, gmeta) = _sparse_operands(torch, dev, pol, M, K, N,
                                                                gated, gen, G)
        return a, None, (expand_24(qb, bmeta), bs), (
            expand_24(qg, gmeta) if gated else None, gs)
    P = NAMED_POLICIES[pol]
    qa, a_s = quantize_operand(torch.randn((M, K), generator=gen, device=dev), P.a, "a")
    shape = (K, N) if G is None else (G, K, N)

    def weight():
        return quantize_operand(torch.randn(shape, generator=gen, device=dev) / math.sqrt(K),
                                P.b, "b")

    return qa.contiguous(), a_s, weight(), weight() if gated else (None, None)


ABFT_PAIRS = ("f32", "bf16", "int8", "fp8", "int8_all", "fp8_all", *SPARSE_POLICIES)


def check_abft(torch, dev, pol, grouped, seed, fused_shape=(8, 2048, 8192),
               grouped_shape=(70, 6144, 4096), sizes=(0, 13, 0, 0, 40, 3, 0, 7),
               fault_tile=(1, 5), fault_row=3):
    """Stage 1d / 5d on one pair: ABFT on bitwise equal to off with no
    tile flagged; an injected fault flags exactly its tile and the flag map
    equals the plain version's; recovery (ops) bitwise; max_retries = 0
    raises SDCError naming the tile; for int8 x int8 a delta of 1 is
    caught.  Times ABFT on against off.  The grouped case: `sizes`, and the
    fault at `fault_tile`, row `fault_row` of the tile."""
    from repro_torch.core import ops
    from repro_torch.kernels import _build
    from repro_torch.kernels import abft as ab
    from repro_torch.kernels import mx_matmul as mm
    from repro_torch.kernels.mx_grouped_matmul import abft_spec_for as grouped_spec
    from repro_torch.kernels.mx_grouped_matmul import mx_grouped_matmul
    from repro_torch.kernels.ref import grouped_matmul_ref

    gen = torch.Generator(device=dev).manual_seed(seed)
    if grouped:
        (T, K, N), G = grouped_shape, len(sizes)
        x, a_s, (w, bs), (wg, gs) = _dense_pair(torch, dev, pol, T, K, N, True, gen, G)
        sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
        out_dtype = torch.float32
        kw = dict(w_gate=wg, activation="swiglu", a_scale=a_s, b_scale=bs, bg_scale=gs,
                  out_dtype=out_dtype)
        spec = grouped_spec(x, w)
        bm, bn = _build.grouped_flag_tile(T, G, x.dtype, w.dtype)

        def run(**k):
            return mx_grouped_matmul(x, w, sz, **kw, **k)

        def plain(**k):
            return grouped_matmul_ref(x, w, sz, **kw, **k)

        def recover(cfg):
            return ops._abft_grouped_gemm(x, w, sz, activation="swiglu", w_gate=wg, a_s=a_s,
                                          b_s=bs, bg_s=gs, out_dtype=out_dtype, cfg=cfg)
        M = T
    else:
        M, K, N = fused_shape
        x, a_s, (w, bs), (wg, gs) = _dense_pair(torch, dev, pol, M, K, N, True, gen)
        out_dtype = torch.float32
        ep = mm.Epilogue(activation="swiglu", a_scale=a_s is not None, b_scale=bs is not None)
        kw = dict(epilogue=ep, b_gate=wg, a_scale=a_s, b_scale=bs, bg_scale=gs,
                  out_dtype=out_dtype)
        spec = mm.abft_spec_for(x, w)
        bm, bn, _ = _build.gemm_tile(M)

        def run(**k):
            return mm.mx_matmul_fused(x, w, **kw, **k)

        def plain(**k):
            return mm.mx_matmul_fused_plain(x, w, **kw, **k)

        def recover(cfg):
            return ops._abft_fused_gemm(x, w, ep=ep, bias=None, residual=None, w_gate=wg,
                                        a_s=a_s, b_s=bs, bg_s=gs, out_dtype=out_dtype, cfg=cfg)
        # the matrix's last row, in the last row tile: at M = 40 (8 rows) and
        # 65 (1 row) that tile is recomputed on the launch's tensor-core route
        fault_tile, fault_row = (-(-M // bm) - 1, 37), (M - 1) % bm
    off = run()
    on, flags = run(abft=spec)
    torch.cuda.synchronize()
    out = dict(clean_bitwise=bool(torch.equal(on, off)), clean_flags=int(flags.sum()))
    gm, gn = flags.shape
    # int8 x int8 compares exactly: a unit delta; a float delta far above
    # the tolerance (fp8 x fp8 sums reach ~1e8 at these widths)
    delta = 1.0 if spec.exact else 1e8
    fault = ab.TileFault(*fault_tile, row=fault_row, col=5, delta=delta)
    fd, fr, fc = ab.build_fault_operands(fault, gm, gn, bm, bn, device=dev)
    fkw = dict(abft=spec.with_inject(True), fault_delta=fd, fault_row=fr, fault_col=fc)
    _, kflags = run(**fkw)
    _, pflags = plain(**fkw)
    want = torch.zeros_like(kflags)
    want[fault_tile] = 1
    out.update(fault_flags_exact=bool(torch.equal(kflags, want)),
               flags_equal_plain=bool(torch.equal(kflags, pflags.to(kflags.device))))
    ab.reset_abft_stats()
    rec = recover(ab.AbftConfig(fault=fault))
    out["recovery_bitwise"] = bool(torch.equal(rec, off))
    out["stats"] = ab.abft_stats()
    try:
        recover(ab.AbftConfig(max_retries=0, fault=fault))
        out["sdc_raised"] = False
    except ab.SDCError as e:
        out["sdc_raised"] = list(e.flagged) == [fault_tile]
    ref, _ = plain(abft=spec)
    err, tol = _err(torch, on, ref, "float32")
    times = _time_ms(torch, dict(ms=(lambda: run(abft=spec), [()]),
                                 off_ms=(lambda: run(), [()]),
                                 plain_ms=(lambda: plain(abft=spec), [()])), windows=3, iters=5)
    out.update(abft_ms=times["ms"], ms=times["ms"], plain_ms=times["plain_ms"],
               off_ms=statistics.median(times["windows_ms"]["off_ms"]), max_abs_err=err,
               tol=tol, library_ms=None)
    # the bound: each operand and the output once (the rows groups own, the
    # weights of live experts), the gated product's operations
    if grouped:
        rows, live = sum(min(n, T) for n in sizes), sum(1 for n in sizes if n)
    else:
        rows, live = M, 1
    nbytes = (x.element_size() * rows * K + 2 * live * w.element_size() * K * N + 4 * M * N
              + (4 * rows if a_s is not None else 0) + (8 * live * N if bs is not None else 0))
    out["bound_ms"], out["bound_by"] = _bound_ms(nbytes, 4 * rows * K * N, _peak_type(x, w))
    out["ok"] = (out["clean_bitwise"] and not out["clean_flags"] and out["fault_flags_exact"]
                 and out["flags_equal_plain"] and out["recovery_bitwise"]
                 and out["sdc_raised"] is True and err <= tol)
    if grouped:
        out["grouped_tile"] = _grouped_tile(x, w, wg, "abft")
    else:
        out["tile"] = _decode_tile(x, w, wg, variant="abft")
        out["prefill_tile"] = _prefill_tile(x, w, wg, "abft")
    return dict(kernel="mx_grouped_matmul" if grouped else "mx_matmul_fused", variant="abft",
                dtype=pol, pair=f"{x.dtype} x {w.dtype}", M=M, K=K, N=N, exact=spec.exact,
                delta=delta, **out)


def _tile_note(c) -> str:
    t = c.get("grouped_tile") or c.get("prefill_tile")
    if t:
        return (f" [{t['route']} tile {t['bm']}x{t['bn']} stages {t['stages']} parts "
                f"{t['parts']} ctas {t['ctas']}]")
    t = c.get("tile")
    return (f" [decode tile bn {t['bn']} bk {t['bk']} tm {t['tm']} stages {t['stages']} "
            f"threads {t['threads']} smem {t['smem']} ctas {t['ctas']} copies "
            f"{t['va']}/{t['vb']} B]" if t else "")


def abft_checks(torch, dev):
    """Phase 3a: both GEMMs on the six dense pairs and the three sparse
    policies (expanded first)."""
    checks, seed = [], 700
    # grok's decode height (8 experts x 8 rows, 16-row tiles over two groups)
    # at its up+gate widths cut to K = 4096: a fault in the second tile of
    # rows, column tile 5, row 11 (expert 3's)
    grok = dict(grouped_shape=(64, 4096, 6144), sizes=(8,) * 8, fault_tile=(1, 5),
                fault_row=11)
    for grouped, shape, pols in (
            (False, dict(fused_shape=(8, 2048, 8192)), ABFT_PAIRS),
            (False, dict(fused_shape=(40, 2048, 8192)), ABFT_PAIRS),
            (False, dict(fused_shape=(65, 2048, 8192)), ABFT_PAIRS),
            (True, {}, ABFT_PAIRS), (True, grok, ("f32", "bf16"))):
        # decode; a verify step and one row past a 64-token chunk (the prefill tile)
        for pol in pols:
            seed += 1
            c = check_abft(torch, dev, pol, grouped, seed, **shape)
            checks.append(c)
            print(f"  {c['kernel']:17s} abft M={c['M']:<3d} {pol:14s} {c['pair']:32s} "
                  f"clean bitwise "
                  f"{c['clean_bitwise']} flags {c['clean_flags']}; fault (delta {c['delta']}) "
                  f"flags its tile {c['fault_flags_exact']}, = plain {c['flags_equal_plain']}; "
                  f"recovery bitwise {c['recovery_bitwise']}; SDCError {c['sdc_raised']}; "
                  f"err vs plain {c['max_abs_err']:.2e} (tol {c['tol']:.2e}); ms on "
                  f"{c['abft_ms']:.4f} off {c['off_ms']:.4f} plain {c['plain_ms']:.4f} bound "
                  f"{c['bound_ms']:.4f}{_tile_note(c)} {'ok' if c['ok'] else 'FAIL'}")
            gc.collect()
            torch.cuda.empty_cache()
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} ABFT check(s) failed: {bad}")
    return checks


def phase_kernels(torch, dev):
    checks = []
    gemm_shapes = [  # (K, N, epilogue): every llama3.2-1b projection, qwen2 widths
        (2048, 2048, dict()),  # q
        (2048, 512, dict()),  # k, v
        (2048, 2048, dict(residual=True)),  # wo
        (2048, 8192, dict(activation="swiglu")),  # up + gate
        (8192, 2048, dict(residual=True)),  # down
        (2048, 8192, dict()),  # the paper's A/B against the baseline GEMM
        (896, 128, dict(bias=True)),  # qwen2-0.5b k, v (qkv bias)
        (4864, 896, dict(residual=True)),  # qwen2-0.5b down
        (2560, 10448, dict()),  # zamba2-2.7b Mamba2 in_proj: N off every tile
        (5120, 2560, dict()),  # zamba2-2.7b Mamba2 out_proj
    ]
    seed = 0
    for dtype_name in ("float32", "bfloat16"):
        # decode slots, a verify step (8 x 5), a prefill chunk, a large batch,
        # zamba2's forward (4 x 512 tokens)
        for M in (8, 40, 64, 256, 2048):
            for K, N, ep in gemm_shapes:
                seed += 1
                checks.append(check_gemm(torch, dev, M, K, N, dtype_name, ep, seed))
            seed += 1
            checks.append(check_baseline(torch, dev, M, 2048, 8192, dtype_name, seed))
        # the decode tile at its other row counts (4: phase 11's decode
        # slots), and misaligned operands
        for M in (1, 4, 16):
            for K, N, ep in ((8192, 2048, dict(residual=True)),
                             (2048, 8192, dict(activation="swiglu")), (2560, 10448, dict())):
                seed += 1
                checks.append(check_gemm(torch, dev, M, K, N, dtype_name, ep, seed))
            seed += 1
            checks.append(check_baseline(torch, dev, M, 2048, 8192, dtype_name, seed))
        for offset in ("a", "b"):
            seed += 1
            checks.append(check_gemm(torch, dev, 8, 2048, 2048, dtype_name,
                                     dict(residual=True), seed, offset=offset))
        # xlstm-125m's decode projections at 8 slots: mLSTM q / k / v and up
        for K, N in ((1536, 1536), (768, 3072)):
            seed += 1
            checks.append(check_gemm(torch, dev, 8, K, N, dtype_name, {}, seed))
        # and its forward's (4 x 512 tokens, f32): up / w_in, q / k / v, down, out
        forward = ((768, 3072), (1536, 1536), (1536, 768), (768, 768))
        for K, N in forward if dtype_name == "float32" else ():
            seed += 1
            checks.append(check_gemm(torch, dev, 2048, K, N, dtype_name, {}, seed, f64=True))
        lengths = (128, 160, 0, 97, 143, 1, 129, 150)  # ragged, one free slot
        qwen = (33, 0, 160, 7)
        for pages in ("same", "int8", "fp8"):
            checks.append(check_decode(torch, dev, 8, 32, 8, 64, 16, lengths, dtype_name,
                                       100, pages=pages))
            checks.append(check_decode(torch, dev, 4, 14, 2, 64, 16, qwen, dtype_name,
                                       101, pages=pages))  # G = 7
            if pages == "same":
                checks.append(check_decode(torch, dev, 8, 32, 8, 64, 16, lengths,
                                           dtype_name, 102, poison=True))
                # long context: 2048 positions per slot, llama3.2-1b's heads
                checks.append(check_decode(torch, dev, 8, 32, 8, 64, 16, (2048,) * 8,
                                           dtype_name, 110, label="long context"))
                # phase 11's 4 decode slots
                checks.append(check_decode(torch, dev, 4, 32, 8, 64, 16, (128, 143, 97, 1),
                                           dtype_name, 111, label="4 slots"))
            # verify windows as the batcher passes them: every active length >= S
            for S, shape, lns, poison in (
                    (5, (8, 32, 8), lengths, False), (5, (4, 14, 2), qwen, False),
                    (9, (8, 32, 8), lengths, False), (5, (8, 32, 8), lengths, True),
                    (1, (8, 32, 8), lengths, False)):
                wl = tuple(ln + S if ln else 0 for ln in lns)
                checks.append(check_verify(torch, dev, *shape, 64, 16, S, wl, dtype_name,
                                           103 + S, poison=poison, pages=pages))
    checks += grouped_checks(torch, dev)
    checks += quant_checks(torch, dev)
    print("[3s] the 2:4 sparse kernels: against the plain versions and bitwise against the "
          "dense kernels on the expanded weights")
    checks += sparse_checks(torch, dev)
    for c in checks:
        if c["kernel"] == "mx_grouped_matmul":
            shape = f"T={c['T']} G={c['G']} K={c['K']} N={c['N']} {c['act']} [{c['label']}]"
        elif "M" in c:
            shape = f"M={c['M']} K={c['K']} N={c['N']} {c.get('epilogue', '')}"
        else:
            shape = (f"B={c['B']} {'S=%d ' % c['S'] if 'S' in c else ''}H={c['H']} "
                     f"Hkv={c['Hkv']} {c['pages'] + ' ' if c['pages'] != 'same' else ''}"
                     f"{'poisoned' if c['poison'] else ''}")
        ok = c["max_abs_err"] <= c["tol"] and c.get("zero_rows_exact", True) \
            and c.get("finite", True) and c.get("decode_bitwise", True) \
            and c.get("bitwise", True) and c.get("bitwise_vs_dense", True) \
            and c.get("f64_err", 0) <= 2 * c.get("plain_f64_err", 0)
        c["ok"] = ok
        lib = "none" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
        extra = (f" vs decode {c['decode_err']:.1e} bitwise {c['decode_bitwise']}"
                 if "decode_err" in c else "")
        if "bitwise" in c:
            extra += f" bitwise {c['bitwise']}"
        if "library_err" in c:
            extra += f" lib err {c['library_err']:.2e}"
        if "bitwise_vs_dense" in c:
            extra += f" = dense kernel on expanded: {c['bitwise_vs_dense']}"
            if c.get("dense_kernel_ms") is not None:
                extra += f" (dense {c['dense_kernel_ms']:.4f} ms)"
        if c.get("library_error"):
            extra += f" lib refused: {c['library_error'][:80]}"
        if c.get("offset"):
            extra += f" ({c['offset']} 4 bytes off)"
        if "f64_err" in c:
            extra += f" to f64: kernel {c['f64_err']:.3e} plain {c['plain_f64_err']:.3e}"
        if c.get("split"):
            t = c["split"]
            extra += (f" [span {t['span_pages']} pages = {t['span_positions']} positions, "
                      f"ring {t['ring']}, cluster {t['cluster']}, grid {t['ctas']} CTAs x "
                      f"{t['threads']} threads]")
            if c.get("label"):
                extra += f" {c['label']} {c['bytes'] / c['ms'] / 1e9:.2f} TB/s"
        if c.get("prefill_tile"):
            t = c["prefill_tile"]
            extra += (f" [{t['route']} prefill tile {t['bm']}x{t['bn']} bk {t['bk']} stages "
                      f"{t['stages']}"
                      f" split {t['split']} parts {t['parts']} smem {t['smem']} ctas "
                      f"{t['ctas']}]")
            if "route_bound_ms" in c:
                extra += f" 3xTF32 bound {c['route_bound_ms']:.4f}"
        if c.get("grouped_tile"):
            t = c["grouped_tile"]
            extra += (f" [{t['route']} tile {t['bm']}x{t['bn']} stages {t['stages']} split "
                      f"{t['split']} parts {t['parts']} ctas {t['ctas']}] {c['tb_s']:.2f} TB/s")
            if "copies_ms" in c:
                extra += (f"; copies only {c['copies_ms']:.4f} ms, "
                          f"{c['copies_tb_s']:.2f} TB/s")
        if c.get("tile"):
            t = c["tile"]
            extra += (f" [decode tile bn {t['bn']} bk {t['bk']} tm {t['tm']} stages "
                      f"{t['stages']} threads {t['threads']} smem {t['smem']} ctas {t['ctas']}"
                      f" copies {t['va']}/{t['vb']}{'/%d' % t['vm'] if 'vm' in t else ''} B]")
        print(f"  {c['kernel']:16s} {c['dtype']:8s} {shape:40s} err {c['max_abs_err']:.3e} "
              f"(tol {c['tol']:.3e}){extra} {'ok' if ok else 'FAIL'}  ms {c['ms']:.4f} "
              f"(spread {100 * _spread(c):.0f}%) plain "
              f"{c['plain_ms']:.4f} lib {lib} bound {c['bound_ms']:.4f} ({c['bound_by']})")
    for dtype_name in ("float32", "bfloat16"):  # the paper's A/B on the decode tile
        mx = next(c for c in checks if c["kernel"] == "mx_matmul_fused" and c["M"] == 8
                  and c["K"] == 2048 and c["N"] == 8192 and c["epilogue"] == {}
                  and c["dtype"] == dtype_name)
        base = next(c for c in checks if c["kernel"] == "baseline_matmul" and c["M"] == 8
                    and c["dtype"] == dtype_name)
        print(f"    A/B at M=8 K=2048 N=8192 {dtype_name} (decode tile): MX {mx['ms']:.4f} ms, "
              f"baseline {base['ms']:.4f} ms (bk 128: 16 output round trips), "
              f"MX {base['ms'] / mx['ms']:.2f}x faster")
    for dtype_name in ("float32", "bfloat16"):  # the paper's A/B on the prefill tile
        for M in (40, 64, 256, 2048):
            mx = next(c for c in checks if c["kernel"] == "mx_matmul_fused" and c["M"] == M
                      and c["K"] == 2048 and c["N"] == 8192 and c["epilogue"] == {}
                      and c["dtype"] == dtype_name)
            base = next(c for c in checks if c["kernel"] == "baseline_matmul"
                        and c["M"] == M and c["dtype"] == dtype_name)
            print(f"    A/B at M={M} K=2048 N=8192 {dtype_name} (prefill tile): MX "
                  f"{mx['ms']:.4f} ms, baseline {base['ms']:.4f} ms, MX "
                  f"{base['ms'] / mx['ms']:.2f}x faster; library {mx['library_ms']:.4f}")
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel check(s) disagree with the plain "
                             f"version: {bad}")
    return checks


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------


def serve(torch, model, params, cfg, backend, n_req, gen, prompt_len=128, slots=8,
          label=None, **kw):
    """The trace of `make_trace` through the paged batcher with the prefix
    cache under `backend`; `kw` (kv_quant, speculate, drafter, abft) goes to
    the batcher.  Launch counts (and the ABFT counters) are set to 0 just
    before the run and read just after it."""
    from repro_torch import kernels
    from repro_torch.core import ops
    from repro_torch.kernels import abft as abft_mod
    from repro_torch.launch.serve import make_trace
    from repro_torch.runtime.batcher import ContinuousBatcher

    max_len = prompt_len + gen
    ps = 16
    with ops.use_policy(ops.MXPolicy(backend)):
        batcher = ContinuousBatcher(
            model, params, batch_slots=slots, max_len=max_len, page_size=ps,
            num_pages=(slots + 2) * -(-max_len // ps), prefix_cache=True,
            prefill_chunk=64, **kw)
        reqs = make_trace(cfg, n_req, prompt_len, gen, prefix_cache=True)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        abft_mod.reset_abft_stats()
        t0 = time.perf_counter()
        for r in reqs:
            batcher.submit(r)
        finished = batcher.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        variants = kernels.variant_launch_counts()
        decode = kernels.decode_launch_counts()
        prefill_tile = kernels.prefill_launch_counts()
        abft_stats = abft_mod.abft_stats()
    step_dt = {h.step: h.dt_s for h in batcher.health}
    # steps that admitted nobody run no prefill chunk: pure decode / verify
    admit_steps = {at for r in finished.values() for kind, at in r.events
                   if kind in ("admitted", "resumed")}
    plain_steps = [1e3 * dt for st, dt in step_dt.items() if st not in admit_steps]
    ttft_steps = [r.first_token_at - r.submitted_at for r in finished.values()]
    ttft_ms = [1e3 * sum(step_dt[s] for s in range(r.submitted_at, r.first_token_at + 1))
               for r in finished.values()]
    generated = sum(len(r.output) for r in finished.values())
    out = dict(
        label=label or backend, backend=backend, requests=len(finished), slots=slots,
        prompt_len=prompt_len,
        kv_cache=kw["kv_quant"].dtype if kw.get("kv_quant") else "f32",
        precision=getattr(cfg, "precision", "none"),
        speculate=kw.get("speculate", 0), spec=batcher.spec_stats(),
        gen=gen, wall_s=wall, steps=batcher.steps_run,
        device_steps=sum(h.active > 0 for h in batcher.health),
        prefill_launches=batcher.prefill_launches, generated_tokens=generated,
        generated_tok_per_s=generated / wall,
        total_tok_per_s=sum(len(r.prompt) + len(r.output)
                            for r in finished.values()) / wall,
        ttft_steps_mean=sum(ttft_steps) / len(ttft_steps), ttft_steps_max=max(ttft_steps),
        ttft_ms_mean=sum(ttft_ms) / len(ttft_ms), ttft_ms_max=max(ttft_ms),
        step_ms_median=statistics.median(plain_steps) if plain_steps else None,
        steps_without_admission=len(plain_steps),
        finish_reasons=batcher.health_summary()["finish_reasons"],
        pool=batcher.pool_stats().as_dict(), prefix=batcher.prefix_stats(),
        launches=counts, variants=variants, decode_launches=decode,
        prefill_tile_launches=prefill_tile, abft_stats=abft_stats,
        abft=batcher.health_summary()["abft"],
        streams={r: finished[r].output for r in sorted(finished)},
        prompts={r: finished[r].prompt.tolist() for r in sorted(finished)})
    assert len(finished) == n_req, finished.keys()
    assert all(r.finish_reason == "max_new" and len(r.output) == gen
               for r in finished.values()), out["finish_reasons"]
    return out, batcher, finished


# ---------------------------------------------------------------------------
# phase 5: kernel path against plain path
# ---------------------------------------------------------------------------


def _step_inputs(torch, dev, cfg, num_pages):
    """One 64-token prefill chunk for slot 0 and one decode step over 8
    slots at ragged depths (slot 3 free), against the serving cache."""
    from repro_torch.runtime.kv_pages import PagePool

    B, ps = 8, 16
    pool = PagePool(num_pages, ps)
    for s in range(B):
        pool.reserve(s, 160)
    table = torch.as_tensor(pool.page_table(B, 10), device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (1, 64), generator=g, device=dev)
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=g, device=dev)
    index = torch.tensor([64, 10, 50, 0, 100, 3, 127, 30], device=dev)
    lengths = (index + 1).to(torch.int32)
    lengths[3] = 0  # a free slot
    return table, toks, tok, index, lengths


@contextlib.contextmanager
def _calls_held(calls, rel_tol=1e-3):
    """Inside the block every GEMM kernel call of the dispatch is also
    computed by its plain version on the same operands: each call appends
    (kernel, max_abs_err, rel_tol * max|ref|) to `calls`.  The plain
    versions launch no kernel, so the launch counts are those of the
    kernel path alone."""
    from repro_torch.core import ops
    from repro_torch.kernels.mx_matmul import mx_matmul_fused_plain
    from repro_torch.kernels.ref import grouped_matmul_ref

    fused, grouped = ops.mx_matmul_fused, ops.mx_grouped_matmul

    def held(name, kernel, plain):
        def call(*args, **kw):
            got = kernel(*args, **kw)
            # the plain versions take 2:4 operands by their metadata alone
            ref = plain(*args, **{k: v for k, v in kw.items() if k != "b_sparse"}).float()
            calls.append((name, (got.float() - ref).abs().max().item(),
                          rel_tol * ref.abs().max().item()))
            return got
        return call

    ops.mx_matmul_fused = held("mx_matmul_fused", fused, mx_matmul_fused_plain)
    ops.mx_grouped_matmul = held("mx_grouped_matmul", grouped, grouped_matmul_ref)
    try:
        yield calls
    finally:
        ops.mx_matmul_fused, ops.mx_grouped_matmul = fused, grouped


def _calls_summary(calls):
    worst = max(calls, key=lambda c: c[1] / max(c[2], 1e-30))
    return dict(calls=len(calls), ok=all(e <= t for _, e, t in calls),
                worst=dict(kernel=worst[0], max_abs_err=worst[1], tol=worst[2]))


def _hold_logits(torch, got, ref, f32, rel_tol):
    """The kernel path's logits against the plain path's.  A quantized
    configuration (`f32` holds the full-precision plain logits) is held at
    half the quantization's own effect on the logits: its quantized
    activations (bf16 casts, int8, fp8) round f32 values that differ in the
    last bit between the paths to neighbouring quanta, which no f32
    tolerance covers; each GEMM call is held at 1e-3 * max|ref| on its own
    operands instead (`_calls_held`)."""
    err = (got - ref).abs().max().item()
    out = dict(max_abs_err=err, argmax_equal=bool(torch.equal(got.argmax(-1),
                                                              ref.argmax(-1))))
    if f32 is None:
        out["tol"] = rel_tol * ref.abs().max().item()
    else:
        out["quant_effect"] = (ref - f32).abs().max().item()
        out["tol"] = 0.5 * out["quant_effect"]
        out["rel_err"] = err / ref.abs().max().item()
    out["ok"] = err <= out["tol"]
    return out


def hold_steps(torch, dev, model, params, cfg, cache0, num_pages, quant=False,
               calls_held=None, ref_precision="none"):
    """One 64-token prefill chunk and one decode step on "cuda_mx" and on
    "torch", each from its own copy of one cache state: logits within
    1e-3 * max|ref|.  With `quant` (a quantized Config.precision) every
    GEMM call of the kernel path is held against its plain version at
    1e-3 * max|ref| (`calls_held`, default `quant`), and the logits as
    `_hold_logits` says, the quantization's own effect taken against the
    plain path under `ref_precision`."""
    from repro_torch import kernels
    from repro_torch.core import ops
    from repro_torch.models import build_model

    table, toks, tok, index, lengths = _step_inputs(torch, dev, cfg, num_pages)
    res, calls = {}, []
    calls_held = quant if calls_held is None else calls_held
    backends = ("cuda_mx", "torch", "f32") if quant else ("cuda_mx", "torch")
    for backend in backends:
        cache = {seg: {k: v.clone() for k, v in leaves.items()}
                 for seg, leaves in cache0.items()}
        m = model
        if backend == "f32":
            m = build_model(dataclasses.replace(cfg, precision=ref_precision))
        held = _calls_held(calls) if calls_held and backend == "cuda_mx" \
            else contextlib.nullcontext()
        with ops.use_policy(ops.MXPolicy("torch" if backend == "f32" else backend)), held:
            kernels.reset_launch_counts()
            pl, cache = m.prefill_step_paged(params, toks, cache,
                                             torch.tensor([0], device=dev), table[:1])
            torch.cuda.synchronize()
            pre = kernels.launch_counts()
            pre_tile = kernels.prefill_launch_counts()
            kernels.reset_launch_counts()
            dl, cache = m.decode_step_paged(params, tok, cache, index, table, lengths)
            torch.cuda.synchronize()
            dec = kernels.launch_counts()
        res[backend] = (pl, dl, pre, dec, pre_tile)
    out = {}
    for i, what in ((0, "prefill_logits"), (1, "decode_logits")):
        out[what] = _hold_logits(torch, res["cuda_mx"][i], res["torch"][i],
                                 res["f32"][i] if quant else None, 1e-3)
    if calls_held:
        out["calls"] = _calls_summary(calls)
    out["launches_per_prefill_chunk"] = res["cuda_mx"][2]
    out["prefill_tile_per_prefill_chunk"] = res["cuda_mx"][4]
    out["launches_per_decode_step"] = res["cuda_mx"][3]
    out["torch_backend_launches"] = [res["torch"][2], res["torch"][3]]
    return out


def _profile(torch, fn):
    """torch.profiler over one call of `fn` (after one warm call): device
    time by kernel and the device's busy share of the window.  A profiler
    that records no device time reports "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): a CPU op's "self device
    # time" is the kernels it launched, which appear as their own rows
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms == 0:
        return dict(measured=False, window_ms=wall_ms)
    # the attention kernels' device time, wherever they rank (flash_split_kernel:
    # the paged decode and verify)
    attention = {}
    grouped = dict(ms=0.0, calls=0)  # the grouped GEMM's kernels (both routes)
    # kernel 1 by K loop: the decode tile (every variant), the prefill tile,
    # and the 16 x 16 CUDA-core loop the decode-height 2:4 and ABFT rows ran
    # before the decode tile took them (it must not appear)
    fused = {k: dict(ms=0.0, calls=0) for k in ("decode", "prefill", "cuda_core_16x16")}
    scan = dict(ms=0.0, calls=0)  # ssd_scan
    library_gemm = dict(ms=0.0, calls=0)  # cuBLAS / CUTLASS GEMMs (the plain path's)
    for k, ms, n in rows:
        if "gemm" in k.lower():
            library_gemm["ms"] += ms
            library_gemm["calls"] += n
        for kern in ("flash_attention_kernel", "flash_split_kernel"):
            if kern in k:
                a = attention.setdefault(kern, dict(ms=0.0, calls=0))
                a["ms"] += ms
                a["calls"] += n
        for name, tally in (("grouped_kernel", grouped), ("grouped_mma_kernel", grouped),
                            ("ssd_scan_kernel", scan), ("mx_matmul_decode", fused["decode"]),
                            ("mx_matmul_prefill", fused["prefill"]),
                            ("mx_matmul_kernel<", fused["cuda_core_16x16"])):
            if name in k:
                tally["ms"] += ms
                tally["calls"] += n
    return dict(measured=True, window_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms, attention=attention, grouped=grouped,
                scan=scan, library_gemm=library_gemm, fused=fused,
                top=[dict(name=k[:90], ms=ms, calls=n) for k, ms, n in rows[:12]])


def _check_decode_profile(what, p):
    """A profiled decode step's GEMMs all on the decode tile: kernel 1's
    decode kernels ran, the 16 x 16 CUDA-core loop did not."""
    if p["measured"] and (not p["fused"]["decode"]["calls"]
                          or p["fused"]["cuda_core_16x16"]["calls"]):
        raise AssertionError(f"{what}: kernel 1 off the decode tile: {p['fused']}")


def profile_steps(torch, dev, model, params, cfg, cache, num_pages, n_decode=4):
    """One prefill chunk and `n_decode` decode steps on the kernel path."""
    from repro_torch.core import ops

    table, toks, tok, index, lengths = _step_inputs(torch, dev, cfg, num_pages)

    def steps():
        model.prefill_step_paged(params, toks, cache, torch.tensor([0], device=dev),
                                 table[:1])
        for _ in range(n_decode):
            model.decode_step_paged(params, tok, cache, index, table, lengths)

    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        return dict(_profile(torch, steps), n_decode=n_decode)


def profile_abft_step(torch, dev, model, params, cfg, cache, num_pages):
    """One decode step on the kernel path under use_abft(): the ABFT
    kernels and the host read of every GEMM's flag map."""
    from repro_torch.core import ops
    from repro_torch.kernels.abft import use_abft

    table, _, tok, index, lengths = _step_inputs(torch, dev, cfg, num_pages)
    with ops.use_policy(ops.MXPolicy("cuda_mx")), use_abft():
        return _profile(torch, lambda: model.decode_step_paged(params, tok, cache, index,
                                                               table, lengths))


def _verify_inputs(torch, dev, cfg, num_pages, S=5):
    """One speculative window of S tokens over 8 slots at ragged depths
    (slot 3 free) against the serving cache, and the decode step that is
    its row 0 on the same state."""
    table, _, _, index, lengths = _step_inputs(torch, dev, cfg, num_pages)
    g = torch.Generator(device=dev).manual_seed(6)
    win = torch.randint(0, cfg.vocab, (table.shape[0], S), generator=g, device=dev)
    vlen = (index + S).to(torch.int32)
    vlen[lengths == 0] = 0
    return table, win, index, vlen, lengths


def _clone(cache0):
    return {seg: {k: v.clone() for k, v in leaves.items()} for seg, leaves in cache0.items()}


@contextlib.contextmanager
def _pages_frozen():
    """Attention's page writes become no-ops inside the block: a step then
    attends over the pages exactly as they are."""
    from repro_torch.models.layers import Attention

    write = Attention.__dict__["_write_kv_pages"]
    Attention._write_kv_pages = staticmethod(lambda cache, *_: cache)
    try:
        yield
    finally:
        Attention._write_kv_pages = write


def hold_verify(torch, dev, model, params, cfg, cache0, num_pages, rel_tol=1e-3):
    """One verify step (S = 5, 8 slots) on the kernel path ("cuda_mx"),
    held against the plain path ("torch") on one page state: the plain
    step, and the decode step that row 0 is checked against, run on copies
    of the cache the kernel path wrote, with page writes frozen, so all
    three attend over identical pages.  Logits within rel_tol * max|ref|.
    For an int8 cache it also counts the page entries the two paths write
    differently on their own (a window row quantized from projections
    summed in another order may round one quantum apart)."""
    from repro_torch import kernels
    from repro_torch.core import ops

    table, win, index, vlen, dlen = _verify_inputs(torch, dev, cfg, num_pages)
    cache_k = _clone(cache0)
    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        kernels.reset_launch_counts()
        vl, _ = model.verify_step_paged(params, win, cache_k, index, table, vlen)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        verify_tile = kernels.prefill_launch_counts()
        with _pages_frozen():
            dl, _ = model.decode_step_paged(params, win[:, :1], _clone(cache_k), index,
                                            table, dlen)
    with ops.use_policy(ops.MXPolicy("torch")):
        kernels.reset_launch_counts()
        with _pages_frozen():
            rl, _ = model.verify_step_paged(params, win, _clone(cache_k), index, table,
                                            vlen)
        torch.cuda.synchronize()
        torch_launches = kernels.launch_counts()
    out = {}
    for what, got, ref in (("verify_logits", vl, rl),
                           ("verify_row0_vs_decode", vl[:, :1], dl)):
        err = (got - ref).abs().max().item()
        tol = rel_tol * ref.abs().max().item()
        out[what] = dict(max_abs_err=err, tol=tol, ok=err <= tol,
                         argmax_equal=bool(torch.equal(got.argmax(-1), ref.argmax(-1))))
    out["launches_per_verify_step"] = launches
    out["prefill_tile_per_verify_step"] = verify_tile
    out["torch_backend_launches"] = torch_launches
    seg = next(iter(cache0))
    if cache0[seg]["k_pages"].dtype == torch.int8:
        cache_p = _clone(cache0)
        with ops.use_policy(ops.MXPolicy("torch")):
            model.verify_step_paged(params, win, cache_p, index, table, vlen)
        diff = torch.cat([(cache_k[seg][k].int() - cache_p[seg][k].int()).abs().flatten()
                          for k in ("k_pages", "v_pages")])
        out["int8_entries_differing"] = int((diff > 0).sum())
        out["int8_max_quanta_apart"] = int(diff.max())
        out["int8_entries_written"] = 2 * cfg.n_layers * int((vlen > 0).sum()) * \
            win.shape[1] * cfg.n_kv_heads * cfg.hd
    return out


def profile_verify(torch, dev, model, params, cfg, cache, num_pages):
    """One verify step (S = 5, 8 slots) on the kernel path."""
    from repro_torch.core import ops

    table, win, index, vlen, _ = _verify_inputs(torch, dev, cfg, num_pages)
    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        return _profile(torch, lambda: model.verify_step_paged(params, win, cache, index,
                                                               table, vlen))


def smoke_streams(torch, dev):
    """Token streams at smoke size: "cuda_mx" and "torch" plain, and, for
    f32 and int8 pages, "cuda_mx" speculative, "cuda_mx" plain and "torch"
    speculative (k = 4, n-gram drafter) must agree within each page type."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import QuantSpec
    from repro_torch.models import build_model

    cfg = get_config("llama3.2-1b-smoke")
    model = build_model(cfg)
    params = model.init(0, device=dev)
    streams = {}
    for kv in (None, "int8"):
        for backend, k in (("cuda_mx", 0), ("torch", 0), ("cuda_mx", 4), ("torch", 4)):
            if kv and (backend, k) == ("torch", 0):
                continue
            r, _, _ = serve(torch, model, params, cfg, backend, n_req=6, gen=8,
                            prompt_len=24, slots=2, speculate=k,
                            kv_quant=QuantSpec(kv) if kv else None)
            streams[f"{backend} {kv or 'f32'} k={k}"] = r["streams"]
    groups = {kv: [v for n, v in streams.items() if kv in n] for kv in ("f32", "int8")}
    same = all(all(v == vs[0] for v in vs) for vs in groups.values())
    return same, streams


def smoke_streams_across_backends(torch, dev, names, precisions):
    """Serving at smoke size: for each arch of `names` and each
    (Config.precision, KV page type[, abft]) of `precisions`, the "cuda_mx" and
    "torch" streams must agree, the kernel path launching the MX GEMM and
    the grouped kernel twice per MoE layer per step or chunk, the plain
    path nothing."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import QuantSpec
    from repro_torch.models import build_model

    out = {}
    for name in names:
        base = get_config(name)
        params = build_model(base).init(0, device=dev)
        for prec, kv, *abft in precisions:
            abft = bool(abft and abft[0])
            cfg = dataclasses.replace(base, precision=prec)
            model = build_model(cfg)
            runs = {b: serve(torch, model, params, cfg, b, n_req=6, gen=8, prompt_len=24,
                             slots=2, kv_quant=QuantSpec(kv) if kv else None, abft=abft)[0]
                    for b in ("cuda_mx", "torch")}
            r = runs["cuda_mx"]
            want = 2 * cfg.n_layers * (r["device_steps"] + r["prefill_launches"]) \
                if cfg.n_experts else 0
            out[f"{name} {prec} {kv or 'f32'} pages{' abft' if abft else ''}"] = dict(
                same=runs["torch"]["streams"] == r["streams"],
                grouped_launches=r["launches"]["mx_grouped_matmul"], want=want,
                fused_launches=r["launches"]["mx_matmul_fused"],
                torch_launches=sum(runs["torch"]["launches"].values()),
                streams={b: v["streams"] for b, v in runs.items()})
        del params
    for label, r in out.items():
        print(f"    {label}: streams equal across cuda_mx / torch: {r['same']}; fused "
              f"launches {r['fused_launches']}, grouped {r['grouped_launches']} (want "
              f"{r['want']})")
        if not r["same"] or r["grouped_launches"] != r["want"] or not r["fused_launches"] \
                or r["torch_launches"]:
            raise AssertionError(f"{label}: {r}")
    return out


def _check_launches(label, run, want_grouped=0):
    """The kernels a serving run's path must launch: the MX GEMM, decode or
    (speculating) verify attention, the grouped GEMM `want_grouped` times;
    nothing of another backend."""
    n = run["launches"]
    spec = run["speculate"] > 0
    if not n["mx_matmul_fused"] or (n["mx_flash_verify"] > 0) != spec \
            or (n["mx_flash_decode"] > 0) == spec or n["baseline_matmul"] \
            or n["mx_grouped_matmul"] != want_grouped:
        raise AssertionError(f"{label}: unexpected kernel launches {n} (want "
                             f"{want_grouped} grouped launches)")


def _print_hold(held, whats):
    for what in whats:
        h = held[what]
        effect = (f", quantization's own effect {h['quant_effect']:.3e}"
                  if "quant_effect" in h else "")
        print(f"    {what}: err {h['max_abs_err']:.3e} (tol {h['tol']:.3e}{effect}) "
              f"argmax equal {h['argmax_equal']}")
    if "calls" in held:
        c = held["calls"]
        print(f"    every GEMM call of the kernel path against its plain version: "
              f"{c['calls']} calls, worst {c['worst']['kernel']} err "
              f"{c['worst']['max_abs_err']:.3e} (tol {c['worst']['tol']:.3e}) "
              f"{'ok' if c['ok'] else 'FAIL'}")


def llama_quant_serve(torch, dev, cfg, params):
    """Phase 4q: llama3.2-1b at full width on the same f32 weights,
    quantized through Config.precision (weights quantized once, at the
    first step): "int8" (the trace of phase 4), "int8_all" (a shorter
    pass), "fp8" with fp8 pages, plain and k = 4 n-gram.  Each run needs its
    kernels launched.  They run before any profiler session of the
    process.  Returns label -> (run, model, batcher)."""
    from repro_torch.core.precision import QuantSpec
    from repro_torch.models import build_model
    from repro_torch.runtime.speculative import NGramDrafter

    print("[4q] quantized serving of llama3.2-1b (the same f32 weights, Config.precision)")
    fp8 = QuantSpec("fp8_e4m3")
    runs = {}
    for label, prec, n_req, gen, kw in (
            ("(d) int8", "int8", 16, 32, {}),
            ("(e) int8_all", "int8_all", 8, 8, {}),
            ("(f) fp8 + fp8 pages", "fp8", 16, 32, dict(kv_quant=fp8)),
            ("(f) fp8 + fp8 pages spec4 ngram", "fp8", 16, 32,
             dict(kv_quant=fp8, speculate=4, drafter=NGramDrafter()))):
        qcfg = dataclasses.replace(cfg, precision=prec)
        model = build_model(qcfg)
        run, batcher, _ = serve(torch, model, params, qcfg, "cuda_mx", n_req=n_req,
                                gen=gen, label=label, **kw)
        _print_serve(run)
        _check_launches(label, run)
        _fused_routes(label, run)
        runs[label] = (run, model, batcher)
    return runs


def llama_quant_holds(torch, dev, params, served):
    """Phase 5q: each quantized run of phase 4q held against the plain path
    on its cache state (a prefill chunk and a decode step: every GEMM call
    at 1e-3 * max|ref|, the logits as `_hold_logits` says) and profiled for
    one decode step (the speculative run: its stream agreement with the
    plain fp8 run recorded, one verify step profiled); then identical
    streams across backends at smoke size."""
    from repro_torch.core import ops
    from repro_torch.core.precision import QuantSpec

    print("[5q] quantized kernel path against plain path")
    holds, profs = {}, {}
    for label, (run, model, batcher) in served.items():
        qcfg, pages = model.cfg, batcher.pool.total_pages
        if run["speculate"]:
            plain = served["(f) fp8 + fp8 pages"][0]
            run["plain_is"] = plain["label"]
            run["streams_equal"] = sum(run["streams"][r] == plain["streams"][r]
                                       for r in run["streams"])
            run["divergences"] = divergences(torch, model, params, plain, run,
                                             QuantSpec("fp8_e4m3"))
            print(f"    {label}: streams equal to [{plain['label']}]: "
                  f"{run['streams_equal']}/{len(run['streams'])} (recorded; fp8 window "
                  f"rows are written from the M = 40 GEMM tile, plain rows from M = 8); "
                  f"divergences {run['divergences']}")
            profs[label] = profile_verify(torch, dev, model, params, qcfg, batcher.cache,
                                          pages)
            _print_profile(f"{label}: 1 verify step, S = 5", profs[label])
            continue
        print(f"    {label}:")
        held = hold_steps(torch, dev, model, params, qcfg, batcher.cache, pages, quant=True)
        _print_hold(held, ("prefill_logits", "decode_logits"))
        for what in ("prefill_logits", "decode_logits", "calls"):
            if not held[what]["ok"]:
                raise AssertionError(f"{label} {what}: the kernel path disagrees: {held}")
        holds[label] = held
        table, _, tok, index, lengths = _step_inputs(torch, dev, qcfg, pages)
        with ops.use_policy(ops.MXPolicy("cuda_mx")):
            profs[label] = _profile(torch, lambda: model.decode_step_paged(
                params, tok, batcher.cache, index, table, lengths))
        _print_profile(f"{label}: 1 decode step, 8 slots", profs[label])
        _check_decode_profile(f"{label}: 1 decode step", profs[label])
    ops.clear_weight_cache()
    print("    quantized token streams at smoke size across backends:")
    streams = smoke_streams_across_backends(
        torch, dev, ("llama3.2-1b-smoke",),
        (("int8", None), ("int8_all", None), ("none", "fp8_e4m3"), ("fp8", "fp8_e4m3")))
    return dict(serve={k: v[0] for k, v in served.items()}, hold=holds, profile=profs,
                smoke_streams=streams)


def _plain_logits(torch, model, params, ctx, kv_quant, chunk=64, ps=16):
    """The plain serving path's next-token logits after `ctx`, on a cache
    of the run's page type: the context but its last token in prefill
    chunks, the last token through a decode step (as the batcher feeds a
    prompt)."""
    from repro_torch.core import ops
    from repro_torch.models.modules import param_device

    dev = param_device(params)
    n = len(ctx)
    pages = -(-n // ps)
    cache = model.make_paged_cache(pages + 1, ps, device=dev, kv_quant=kv_quant)
    table = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)[None]
    toks = torch.as_tensor(ctx, device=dev)[None]
    with ops.use_policy(ops.MXPolicy("cuda_mx")), torch.no_grad():
        for s in range(0, n - 1, chunk):
            model.prefill_step_paged(params, toks[:, s:min(s + chunk, n - 1)], cache,
                                     torch.tensor([s], device=dev), table)
        logits, _ = model.decode_step_paged(
            params, toks[:, n - 1:], cache, torch.tensor([n - 1], device=dev), table,
            torch.tensor([n], dtype=torch.int32, device=dev))
    return logits.reshape(-1)


def divergences(torch, model, params, plain, other, kv_quant=None):
    """For each stream of `other` that leaves the plain greedy stream: the
    first divergent token, the plain path's top-2 logit gap there and phase
    5's tolerance on those logits (1e-3 * max|logit|), over prompt + the
    shared prefix on pages of the run's type.  A stream that stops early
    (a quarantined request) but agrees as far as it goes does not leave."""
    out = []
    for rid, toks in other["streams"].items():
        ref = plain["streams"][rid]
        t = next((i for i, (a, b) in enumerate(zip(toks, ref)) if a != b), None)
        if t is None:
            continue
        ctx = list(other["prompts"][rid]) + ref[:t]
        logits = _plain_logits(torch, model, params, ctx, kv_quant)
        top2 = logits.topk(2).values
        out.append(dict(rid=rid, token=t, plain=ref[t], got=toks[t],
                        top2_gap=(top2[0] - top2[1]).item(),
                        tol=1e-3 * logits.abs().max().item()))
    return out


def _fused_routes(label, run):
    """Kernel 1's launches in a serving run by K loop: every decode step's
    (M <= 16) on the decode tile, every prefill chunk's and verify step's
    on the tensor-core prefill tile, in every variant; nothing else."""
    n, dec = run["launches"]["mx_matmul_fused"], run["decode_launches"]["mx_matmul_fused"]
    mma = run["prefill_tile_launches"]["mx_matmul_fused"]
    run["fused_by_route"] = dict(decode=dec, mma=mma)
    print(f"      kernel 1 launches by route: {run['fused_by_route']} of {n}")
    decode_steps = run["speculate"] == 0  # a speculating run verifies on the prefill tile
    if bool(dec) != decode_steps or not mma or dec + mma != n:
        raise AssertionError(f"{label}: kernel 1 off the decode and prefill tiles: "
                             f"{run['fused_by_route']} of {n}")


def _sparse_payload_gib(ops):
    """The kept 2:4 payloads and metadata (the weight cache's sparse entries)."""
    return sum(t.numel() * t.element_size() for key, (_, _, made) in ops._weights.items()
               if key[-1] is not None for t in made if t is not None) / 2**30


def _check_variant(label, run, variant, grouped=False, dense_heads=0):
    """A run of a 2:4 or ABFT configuration must launch that variant of the
    GEMM(s); a 2:4 run no dense one (no fallback) but its `dense_heads`
    launches of an untied head, which keeps its declared precision, as in
    JAX.  An ABFT run's prefill chunks run dense GEMMs: the batcher
    checksums its device step, as JAX's does."""
    v = run["variants"]
    names = ("mx_matmul_fused",) + (("mx_grouped_matmul",) if grouped else ())
    for name in names:
        heads = dense_heads if name == "mx_matmul_fused" else 0
        if v[f"{name} {variant}"] <= 0 or (variant == "sparse" and v[f"{name} dense"] != heads):
            raise AssertionError(f"{label}: {name} launches by variant {v}")


def llama_sparse_serve(torch, dev, cfg, params):
    """Phase 4s: llama3.2-1b on the same f32 weights under Config.precision
    "sparse24" and "sparse24_int8" (the phase 4 trace; the tied head stays
    dense f32, as in JAX), each GEMM's pruned, quantized, compressed weight
    made once at the first step.  Every GEMM launch is the 2:4 variant.
    Returns label -> (run, model, batcher)."""
    from repro_torch.core import ops
    from repro_torch.models import build_model

    print("[4s] 2:4 sparse serving of llama3.2-1b (the same f32 weights, Config.precision)")
    runs = {}
    for label, prec in (("(g) sparse24", "sparse24"), ("(h) sparse24_int8", "sparse24_int8")):
        qcfg = dataclasses.replace(cfg, precision=prec)
        model = build_model(qcfg)
        run, batcher, _ = serve(torch, model, params, qcfg, "cuda_mx", n_req=16, gen=32,
                                label=label)
        run["sparse_payload_gib"] = _sparse_payload_gib(ops)
        _print_serve(run)
        print(f"      kept 2:4 payloads + metadata {run['sparse_payload_gib']:.3f} GiB; "
              f"launches by variant {run['variants']}")
        _check_launches(label, run)
        _check_variant(label, run, "sparse")
        _fused_routes(label, run)
        runs[label] = (run, model, batcher)
    return runs


def llama_abft_serve(torch, dev, cfg, model, params, main_run):
    """Phase 4a: llama f32 with abft=True on the phase 4 trace: streams
    bitwise those of phase 4, no tile flagged, no host-copy SDC; then a short
    pass (8 requests x 8 tokens) with k = 4 n-gram speculation, with and
    without ABFT (bitwise equal streams).  The eager protocol reads each
    GEMM's flag map on the host: one sync per GEMM, its cost in the step."""
    from repro_torch.runtime.speculative import NGramDrafter

    print("[4a] ABFT serving of llama3.2-1b (f32, abft=True)")
    run, _, _ = serve(torch, model, params, cfg, "cuda_mx", n_req=16, gen=32,
                      label="(i) abft", abft=True)
    _print_serve(run)
    run["gemms_verified_per_step"] = run["abft_stats"]["gemms_verified"] / run["device_steps"]
    run["streams_equal_plain"] = run["streams"] == main_run["streams"]
    run["step_ms_vs_plain"] = run["step_ms_median"] / main_run["step_ms_median"]
    print(f"      abft counters {run['abft_stats']}, host audit {run['abft']}; "
          f"{run['gemms_verified_per_step']:.1f} verified GEMMs (host syncs) per step; "
          f"streams bitwise equal to phase 4's: {run['streams_equal_plain']}; median step "
          f"{run['step_ms_median']:.2f} ms against {main_run['step_ms_median']:.2f} ms "
          f"({run['step_ms_vs_plain']:.2f}x)")
    spec = {}
    for abft in (True, False):
        spec[abft], _, _ = serve(torch, model, params, cfg, "cuda_mx", n_req=8, gen=8,
                                 label=f"(i) spec4 ngram {'abft' if abft else 'plain'}",
                                 speculate=4, drafter=NGramDrafter(), abft=abft)
        _print_serve(spec[abft])
    s = run["abft_stats"]
    ok = (run["streams_equal_plain"] and s["gemms_verified"] > 0 and s["tiles_flagged"] == 0
          and s["sdc_errors"] == 0 and run["abft"]["sdc_detected"] == 0
          and spec[True]["streams"] == spec[False]["streams"]
          and spec[True]["abft_stats"]["tiles_flagged"] == 0
          and spec[True]["abft_stats"]["gemms_verified"] > 0)
    print(f"      speculative pass: streams with ABFT equal without: "
          f"{spec[True]['streams'] == spec[False]['streams']}; counters "
          f"{spec[True]['abft_stats']}")
    _check_launches("(i) abft", run)
    _check_variant("(i) abft", run, "abft")
    _fused_routes("(i) abft", run)
    if run["variants"]["mx_matmul_fused abft"] != run["fused_by_route"]["decode"]:
        raise AssertionError(f"(i) abft: the decode steps' GEMMs off the ABFT decode tile: "
                             f"{run['variants']} {run['fused_by_route']}")
    _check_variant("(i) spec4 ngram abft", spec[True], "abft")
    if not ok:
        raise AssertionError(f"ABFT serving: {run['abft_stats']} {run['abft']} "
                             f"{spec[True]['abft_stats']}")
    return dict(serve=run, spec=spec[True], spec_plain=spec[False])


def llama_sparse_holds(torch, dev, params, served):
    """Phase 5s: each sparse run of phase 4s on its cache state, a prefill
    chunk and a decode step: every GEMM call against its plain version at
    1e-3 * max|ref|; "sparse24" logits at 1e-3 * max|ref| against the plain
    path (no activation is quantized), "sparse24_int8" logits at half the
    quantization's own effect (against the plain "sparse24" path, so the
    pruning is not counted as quantization); then identical smoke-size
    streams across backends under both policies and with abft=True."""
    from repro_torch.core import ops

    print("[5s] 2:4 kernel path against plain path")
    holds, profs = {}, {}
    for label, (run, model, batcher) in served.items():
        qcfg = model.cfg
        quant = qcfg.precision == "sparse24_int8"
        held = hold_steps(torch, dev, model, params, qcfg, batcher.cache,
                          batcher.pool.total_pages, quant=quant, calls_held=True,
                          ref_precision="sparse24")
        print(f"    {label}:")
        _print_hold(held, ("prefill_logits", "decode_logits"))
        for what in ("prefill_logits", "decode_logits", "calls"):
            if not held[what]["ok"]:
                raise AssertionError(f"{label} {what}: the kernel path disagrees: {held}")
        holds[label] = held
        table, _, tok, index, lengths = _step_inputs(torch, dev, qcfg, batcher.pool.total_pages)
        with ops.use_policy(ops.MXPolicy("cuda_mx")):
            profs[label] = _profile(torch, lambda: model.decode_step_paged(
                params, tok, batcher.cache, index, table, lengths))
        _print_profile(f"{label}: 1 decode step, 8 slots", profs[label])
        _check_decode_profile(f"{label}: 1 decode step", profs[label])
    ops.clear_weight_cache()
    print("    2:4 and ABFT token streams at smoke size across backends:")
    streams = smoke_streams_across_backends(
        torch, dev, ("llama3.2-1b-smoke",),
        (("sparse24", None), ("sparse24_int8", None), ("none", None, True)))
    return dict(serve={k: v[0] for k, v in served.items()}, hold=holds, profile=profs,
                smoke_streams=streams)


# ---------------------------------------------------------------------------


def llama_phases(torch, dev):
    """Phases 4 and 5: llama3.2-1b at full width.  Returns the runs and
    holds, and each kernel's launches on its serving path."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import QuantSpec
    from repro_torch.models import build_model
    from repro_torch.models.modules import param_count
    from repro_torch.runtime.speculative import DraftModelProposer, NGramDrafter, TraceDrafter

    print("[4] serving llama3.2-1b (f32, full width) through the paged batcher")
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    print(f"    init {time.perf_counter() - t0:.1f} s, "
          f"{param_count(params) / 1e9:.3f} B params")
    main_run, batcher, _ = serve(torch, model, params, cfg, "cuda_mx", n_req=16, gen=32)
    _print_serve(main_run)
    base_run, _, _ = serve(torch, model, params, cfg, "cuda_baseline", n_req=8, gen=8)
    _print_serve(base_run)
    # this slice's runs on the same trace: speculation (k = 4) and int8 pages
    traces = [main_run["prompts"][r] + main_run["streams"][r] for r in main_run["streams"]]
    int8 = QuantSpec("int8")
    spec_runs = {}
    for label, kw in (
            ("(a) spec4 trace overlap 1.0", dict(speculate=4,
                                                 drafter=TraceDrafter(traces))),
            ("(b) spec4 ngram", dict(speculate=4, drafter=NGramDrafter())),
            ("(c) int8 plain", dict(kv_quant=int8)),
            ("(c) int8 spec4 ngram", dict(kv_quant=int8, speculate=4,
                                          drafter=NGramDrafter()))):
        run, b, _ = serve(torch, model, params, cfg, "cuda_mx", n_req=16, gen=32,
                          label=label, **kw)
        spec_runs[label] = run
        if label == "(c) int8 spec4 ngram":
            int8_batcher = b
    # every speculative stream against its plain counterpart (int8 pages
    # round K/V, so the int8 plain stream is the int8 reference; its
    # agreement with the f32 stream is recorded, not required)
    for label, run in spec_runs.items():
        if run["speculate"]:
            plain = spec_runs["(c) int8 plain"] if "int8" in label else main_run
            run["plain_is"] = plain["label"]
            run["streams_equal"] = sum(run["streams"][r] == plain["streams"][r]
                                       for r in run["streams"])
            run["divergences"] = divergences(torch, model, params, plain, run,
                                             int8 if "int8" in label else None)
        else:
            run["streams_equal_f32"] = sum(run["streams"][r] == main_run["streams"][r]
                                           for r in run["streams"])
        _print_serve(run)
    # the draft model: the target's own weights, context past max_len
    draft = DraftModelProposer(model, params, max_context=256)
    dm_run, _, _ = serve(torch, model, params, cfg, "cuda_mx", n_req=4, gen=8,
                         label="draft-model spec4", speculate=4, drafter=draft)
    dm_run["forwards"] = draft.forwards
    dm_run["plain_is"] = main_run["label"]
    dm_run["streams_equal"] = sum(dm_run["streams"][r] == main_run["streams"][r][:8]
                                  for r in dm_run["streams"])
    dm_run["divergences"] = divergences(
        torch, model, params, dict(streams={r: main_run["streams"][r][:8]
                                            for r in dm_run["streams"]}), dm_run)
    _print_serve(dm_run)
    spec_runs[dm_run["label"]] = dm_run

    # the draft model's full forwards run the flash attention kernel; no
    # other llama run does (its paged path has no full forward)
    if dm_run["launches"]["mx_flash_attention"] <= 0 or dm_run["launches"]["ssd_scan"]:
        raise AssertionError(f"draft-model run: unexpected launches {dm_run['launches']}")
    # llama is dense: the grouped kernel's launches come from grok (phase 6),
    # ssd_scan's and the flash attention's from zamba2's forward (phase 8)
    launches = {k: n for k, n in main_run["launches"].items()
                if k not in ("mx_grouped_matmul", "ssd_scan", "mx_flash_attention")}
    launches["baseline_matmul"] = base_run["launches"]["baseline_matmul"]
    launches["mx_flash_verify"] = spec_runs["(b) spec4 ngram"]["launches"]["mx_flash_verify"]
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on its serving path")
    # the decode steps' GEMMs (M = 8 slots) run the decode tile (csrc/decode_tile.cuh)
    if main_run["decode_launches"]["mx_matmul_fused"] <= 0 \
            or base_run["decode_launches"]["baseline_matmul"] <= 0:
        raise AssertionError(f"the decode tile was not launched: {main_run['decode_launches']}"
                             f" / {base_run['decode_launches']}")
    # the prefill chunks' GEMMs (M = 64) and the verify steps' (M = 40) run
    # the tensor-core prefill tile (csrc/prefill_tile.cuh)
    spec_tile = spec_runs["(b) spec4 ngram"]["prefill_tile_launches"]
    if main_run["prefill_tile_launches"]["mx_matmul_fused"] <= 0 \
            or base_run["prefill_tile_launches"]["baseline_matmul"] <= 0 \
            or spec_tile["mx_matmul_fused"] <= 0:
        raise AssertionError(f"the prefill tile was not launched: "
                             f"{main_run['prefill_tile_launches']} / "
                             f"{base_run['prefill_tile_launches']} / {spec_tile}")
    if main_run["launches"]["baseline_matmul"] or base_run["launches"]["mx_matmul_fused"] \
            or main_run["launches"]["mx_grouped_matmul"] or main_run["launches"]["ssd_scan"] \
            or main_run["launches"]["mx_flash_attention"]:
        raise AssertionError(f"backends leaked into each other: {main_run['launches']} "
                             f"/ {base_run['launches']}")
    for label, run in spec_runs.items():
        _check_launches(label, run)

    served = llama_quant_serve(torch, dev, cfg, params)
    sparse_served = llama_sparse_serve(torch, dev, cfg, params)
    abft = llama_abft_serve(torch, dev, cfg, model, params, main_run)
    dense = llama_dense_phase(torch, dev, model, params, cfg)

    print("[5] kernel path against plain path")
    held = hold_steps(torch, dev, model, params, cfg, batcher.cache,
                      batcher.pool.total_pages)
    held_v = hold_verify(torch, dev, model, params, cfg, batcher.cache,
                         batcher.pool.total_pages)
    # int8: on their own, the two paths may write a window row one quantum
    # (amax / 127 of its row) apart; the logits are held on one page state,
    # and the pages at one quantum
    held_v8 = hold_verify(torch, dev, model, params, cfg, int8_batcher.cache,
                          int8_batcher.pool.total_pages)
    print(f"    int8 verify step: {held_v8['int8_entries_differing']} of "
          f"{held_v8['int8_entries_written']} written page entries differ between the "
          f"paths, at most {held_v8['int8_max_quanta_apart']} quantum apart")
    if held_v8["int8_max_quanta_apart"] > 1:
        raise AssertionError(f"int8 pages differ by more than one quantum: {held_v8}")
    for what, h in (("prefill_logits", held["prefill_logits"]),
                    ("decode_logits", held["decode_logits"]),
                    ("verify_logits", held_v["verify_logits"]),
                    ("verify_row0_vs_decode", held_v["verify_row0_vs_decode"]),
                    ("int8 verify_logits", held_v8["verify_logits"]),
                    ("int8 verify_row0_vs_decode", held_v8["verify_row0_vs_decode"])):
        print(f"    {what}: err {h['max_abs_err']:.3e} (tol {h['tol']:.3e}) "
              f"argmax equal {h['argmax_equal']}")
        if not h["ok"]:
            raise AssertionError(f"{what}: the kernel path disagrees: {h}")
    print(f"    launches per prefill chunk (64 tokens): {held['launches_per_prefill_chunk']}")
    print(f"    launches per decode step (8 slots): {held['launches_per_decode_step']}")
    print(f"    launches per verify step (8 slots x 5 rows): "
          f"{held_v['launches_per_verify_step']}")
    # every GEMM of a prefill chunk (M = 64) and of a verify step (M = 40)
    # on the tensor-core prefill tile
    print(f"    of them on the prefill tile: chunk {held['prefill_tile_per_prefill_chunk']}, "
          f"verify step {held_v['prefill_tile_per_verify_step']}")
    for what, tile, per in (
            ("prefill chunk", held["prefill_tile_per_prefill_chunk"],
             held["launches_per_prefill_chunk"]),
            ("verify step", held_v["prefill_tile_per_verify_step"],
             held_v["launches_per_verify_step"])):
        if not 0 < tile["mx_matmul_fused"] == per["mx_matmul_fused"]:
            raise AssertionError(f"{what}: GEMMs off the prefill tile: {tile} of {per}")
    prof = profile_steps(torch, dev, model, params, cfg, batcher.cache,
                         batcher.pool.total_pages)
    prof_v = profile_verify(torch, dev, model, params, cfg, batcher.cache,
                            batcher.pool.total_pages)
    _print_profile(f"1 prefill chunk + {prof['n_decode']} decode steps", prof)
    _print_profile("1 verify step, S = 5", prof_v)
    prof_a = profile_abft_step(torch, dev, model, params, cfg, batcher.cache,
                               batcher.pool.total_pages)
    _print_profile("1 decode step with ABFT (a host sync per GEMM)", prof_a)
    _check_decode_profile("1 decode step with ABFT", prof_a)
    abft["profile_decode"] = prof_a
    same, streams = smoke_streams(torch, dev)
    print(f"    smoke-size token streams equal across cuda_mx / torch, plain / "
          f"speculative, f32 and int8 (each within its page type): {same}")
    if not same:
        raise AssertionError(f"token streams differ: {streams}")
    # greedy-exact: a full-width speculative stream may leave the plain one
    # only at a near tie, a top-2 logit gap below the kernel path's error
    near_tie = max(held["decode_logits"]["max_abs_err"],
                   held_v["verify_logits"]["max_abs_err"])
    for label, run in (*spec_runs.items(), ("llama dense vs paged", dense)):
        bad = [d for d in run.get("divergences", ()) if d["top2_gap"] > near_tie]
        if bad:
            raise AssertionError(f"{label}: streams leave the plain ones away from a "
                                 f"near tie (kernel-path error {near_tie:.3e}): {bad}")

    quant = llama_quant_holds(torch, dev, params, served)
    sparse = llama_sparse_holds(torch, dev, params, sparse_served)
    return launches, dict(quant=quant, sparse=sparse, abft=abft, dense=dense, serve=main_run,
                          serve_baseline=base_run,
                          serve_spec=spec_runs, hold=held, hold_verify=held_v,
                          hold_verify_int8=held_v8, profile=prof, profile_verify=prof_v,
                          smoke_streams=streams)


@contextlib.contextmanager
def _router_probs_recorded(out):
    """Every MoE router call appends its (G, Tg, E) probabilities to `out`."""
    from repro_torch.models.moe import MoE

    probs = MoE.router_probs

    def recorded(self, p, xg):
        pr = probs(self, p, xg)
        out.append(pr.detach().clone())
        return pr

    MoE.router_probs = recorded
    try:
        yield
    finally:
        MoE.router_probs = probs


MOE_STEPS = ("prefill64", "prefill31", "decode")


def hold_moe_steps(torch, dev, model, params, cfg, cache0, num_pages, rel_tol=1e-3,
                   steps=MOE_STEPS, quant=False):
    """A 64-token prefill chunk (G = 16 routing groups) and a 31-token chunk
    (G = 1) for slot 0, then a decode step over 8 slots (those of `steps`,
    in that order), on "cuda_mx" and on "torch", each from its own copy of
    one cache state.  Logits within rel_tol * max|ref| (with `quant`, as
    `hold_steps` holds a quantized configuration: every GEMM call at 1e-3,
    the logits against the quantization's own effect).  Routing is plain
    torch on both paths, fed by different GEMMs: the router probabilities
    of every MoE call are compared, giving the smallest 2nd-3rd probability
    gap (top-2) and the first call whose top-k sets differ, with the
    largest probability error up to it."""
    from repro_torch import kernels
    from repro_torch.core import ops
    from repro_torch.models import build_model

    table, toks, tok, index, lengths = _step_inputs(torch, dev, cfg, num_pages)
    g = torch.Generator(device=dev).manual_seed(7)
    toks31 = torch.randint(0, cfg.vocab, (1, 31), generator=g, device=dev)
    res, calls = {}, []
    for backend in ("cuda_mx", "torch", "f32") if quant else ("cuda_mx", "torch"):
        cache, probs, logits, counts = _clone(cache0), [], [], []
        m = model
        if backend == "f32":
            m = build_model(dataclasses.replace(cfg, precision="none"))
        run = dict(
            prefill64=lambda: m.prefill_step_paged(
                params, toks, cache, torch.tensor([0], device=dev), table[:1]),
            prefill31=lambda: m.prefill_step_paged(
                params, toks31, cache, torch.tensor([64], device=dev), table[:1]),
            decode=lambda: m.decode_step_paged(params, tok, cache, index, table, lengths))
        held = _calls_held(calls) if quant and backend == "cuda_mx" \
            else contextlib.nullcontext()
        with ops.use_policy(ops.MXPolicy("torch" if backend == "f32" else backend)), \
                _router_probs_recorded(probs), held:
            for step in (run[k] for k in steps):
                kernels.reset_launch_counts()
                logits.append(step()[0])
                torch.cuda.synchronize()
                counts.append(kernels.launch_counts())
        res[backend] = (logits, counts, probs)
    out = {}
    for i, what in enumerate(f"{k}_logits" for k in steps):
        out[what] = _hold_logits(torch, res["cuda_mx"][0][i], res["torch"][0][i],
                                 res["f32"][0][i] if quant else None, rel_tol)
    if quant:
        out["calls"] = _calls_summary(calls)
    pk, pp = res["cuda_mx"][2], res["torch"][2]
    k = cfg.top_k
    top = [p.topk(k + 1, dim=-1).values for p in pk]
    gaps = [(v[..., k - 1] - v[..., k]).min().item() for v in top]
    flip, err_to_flip = None, 0.0
    for i, (a, b) in enumerate(zip(pk, pp)):
        err_to_flip = max(err_to_flip, (a - b).abs().max().item())
        if not torch.equal(a.topk(k, dim=-1).indices.sort(-1).values,
                           b.topk(k, dim=-1).indices.sort(-1).values):
            flip = i
            break
    out["router"] = dict(calls=len(pk), min_gap_2nd_3rd=min(gaps), first_flip_call=flip,
                         prob_err_to_flip=err_to_flip)
    out["launches"] = dict(zip(steps, res["cuda_mx"][1]))
    out["torch_backend_launches"] = res["torch"][1]
    return out


def _print_profile(what, p):
    if p["measured"]:
        print(f"    profile ({what}): window {p['window_ms']:.2f} ms, device busy "
              f"{p['device_ms']:.2f} ms ({100 * p['busy_share']:.1f}%)")
        for r in p["top"]:
            print(f"      {r['ms']:9.3f} ms  x{r['calls']:<5d} {r['name']}")
        for k, a in p["attention"].items():
            print(f"      attention: {k} {a['ms']:.3f} ms over {a['calls']} calls "
                  f"({100 * a['ms'] / p['device_ms']:.1f}% of device time)")
        for what_, g in (("grouped GEMM", p["grouped"]), ("ssd_scan", p["scan"]),
                         *((f"kernel 1 {k}", v) for k, v in p["fused"].items())):
            if g["calls"]:
                print(f"      {what_}: {g['ms']:.3f} ms over {g['calls']} launches "
                      f"({100 * g['ms'] / p['device_ms']:.1f}% of device time)")
    else:
        print(f"    profile ({what}): device time not measured "
              f"(window {p['window_ms']:.2f} ms)")


def grok_phases(torch, dev):
    """Phases 6 and 7: grok-1-314b at full width, 2 of its 64 layers."""
    from repro_torch.configs import get_config
    from repro_torch.core import ops
    from repro_torch.models import build_model
    from repro_torch.models.modules import param_count

    full = get_config("grok-1-314b")
    cfg = dataclasses.replace(full, n_layers=2, blocks=(("moe", 2),))
    print(f"[6] serving grok-1-314b (f32, full width) through the paged batcher; depth "
          f"cut: n_layers {full.n_layers} -> {cfg.n_layers}")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"    init {init_s:.1f} s, {param_count(params) / 1e9:.3f} B params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    run, batcher, _ = serve(torch, model, params, cfg, "cuda_mx", n_req=16, gen=16)
    run["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    _print_serve(run)
    print(f"      peak device memory {run['peak_memory_gib']:.2f} GiB; "
          f"{run['device_steps']} device steps")
    _check_launches("grok serving", run,
                    2 * cfg.n_layers * (run["device_steps"] + run["prefill_launches"]))

    qserved = grok_quant_serve(torch, dev, cfg, params)
    sserved = grok_sparse_serve(torch, dev, cfg, params)
    abft = grok_abft_pass(torch, dev, cfg, model, params)

    print("[7] grok kernel path against plain path")
    held = _hold_grok(torch, dev, model, params, cfg, batcher)
    prof = _profile_grok(torch, dev, model, params, cfg, batcher, "1 grok decode step, 8 slots")
    del batcher
    print("[7s] grok sparse24_int8 kernel path against plain path")
    srun, smodel, sbatcher = sserved
    sheld = _hold_grok(torch, dev, smodel, params, smodel.cfg, sbatcher, "grok sparse24_int8",
                       quant=True)
    del sserved, smodel, sbatcher
    ops.clear_weight_cache()  # the 2:4 payloads; 7q makes its int8 ones again
    quant = grok_quant_holds(torch, dev, cfg, params, *qserved)
    del params, model, qserved
    gc.collect()
    torch.cuda.empty_cache()
    streams = smoke_streams_across_backends(
        torch, dev, ("grok-1-314b-smoke", "kimi-k2-1t-a32b-smoke"),
        (("none", None), ("int8", None), ("int8_all", None), ("sparse24_int8", None),
         ("none", None, True)))
    return dict(config=dict(name=cfg.name, n_layers=cfg.n_layers, cut_from=full.n_layers),
                init_s=init_s, serve=run, hold=held, profile_decode=prof,
                smoke_streams=streams, quant=quant, abft=abft,
                sparse=dict(serve=srun, hold=sheld))


def _hold_grok(torch, dev, model, params, cfg, batcher, label="grok", steps=MOE_STEPS,
               quant=False):
    """hold_moe_steps on the batcher's cache state, printed and required:
    logits within 1e-3 * max|ref| (with `quant`, as `_hold_logits` says,
    and every GEMM call at 1e-3 against its plain version; a failure behind
    a top-2 routing flip decided by less than 1e-4 of router probability is
    a near tie, not a fault) and 2 grouped launches per MoE layer per step
    or chunk."""
    held = hold_moe_steps(torch, dev, model, params, cfg, batcher.cache,
                          batcher.pool.total_pages, steps=steps, quant=quant)
    rt = held["router"]
    print(f"    router: {rt['calls']} calls, smallest 2nd-3rd probability gap "
          f"{rt['min_gap_2nd_3rd']:.3e}; first top-2 flip between the paths: "
          f"{rt['first_flip_call']} (router probability error up to it "
          f"{rt['prob_err_to_flip']:.3e})")
    _print_hold(held, [f"{k}_logits" for k in steps])
    if quant and not held["calls"]["ok"]:
        raise AssertionError(f"{label}: a GEMM call disagrees with its plain version: "
                             f"{held['calls']}")
    for what in (f"{k}_logits" for k in steps):
        h = held[what]
        near_tie = rt["first_flip_call"] is not None and rt["prob_err_to_flip"] <= 1e-4
        if not h["ok"] and not near_tie:
            raise AssertionError(f"{label} {what}: the kernel path disagrees: {h}, {rt}")
        h["near_tie"] = not h["ok"] and near_tie
    for what, c in held["launches"].items():
        print(f"    launches per {what}: {c}")
        if c["mx_grouped_matmul"] != 2 * cfg.n_layers:
            raise AssertionError(f"{label} {what}: {c['mx_grouped_matmul']} grouped "
                                 f"launches, want {2 * cfg.n_layers}")
    return held


def _profile_grok(torch, dev, model, params, cfg, batcher, what):
    from repro_torch.core import ops

    table, _, tok, index, lengths = _step_inputs(torch, dev, cfg, batcher.pool.total_pages)
    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        prof = _profile(torch, lambda: model.decode_step_paged(
            params, tok, batcher.cache, index, table, lengths))
    _print_profile(what, prof)
    return prof


def grok_quant_serve(torch, dev, cfg, params):
    """Phase 6q: grok-1 (the same cut and f32 weights) served with
    Config.precision "int8": the f32 weights stay on the card and the int8
    payloads are kept beside them (quantized once, at the first step); 2
    grouped launches per MoE layer per step or chunk.  Returns (run, model,
    batcher)."""
    from repro_torch.core import ops
    from repro_torch.models import build_model

    print("[6q] serving grok-1-314b with Config.precision int8 (same cut, same weights)")
    qcfg = dataclasses.replace(cfg, precision="int8")
    model = build_model(qcfg)
    torch.cuda.reset_peak_memory_stats()
    run, batcher, _ = serve(torch, model, params, qcfg, "cuda_mx", n_req=16, gen=16,
                            label="grok int8")
    run["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    run["weight_payload_gib"] = sum(
        made[0].numel() * made[0].element_size() for _, _, made in ops._weights.values()) / 2**30
    _print_serve(run)
    print(f"      peak device memory {run['peak_memory_gib']:.2f} GiB, of which int8 weight "
          f"payloads kept {run['weight_payload_gib']:.2f} GiB; {run['device_steps']} "
          f"device steps")
    _check_launches("grok int8", run,
                    2 * cfg.n_layers * (run["device_steps"] + run["prefill_launches"]))
    return run, model, batcher


def grok_sparse_serve(torch, dev, cfg, params):
    """Phase 6s: grok-1 (the same cut and f32 weights) under "sparse24_int8":
    each expert stack pruned, quantized and compressed one expert at a time
    at the first step and kept beside the f32 weights (peak memory
    printed); 2 grouped launches per MoE layer per step or chunk, every one
    the 2:4 variant.  Returns (run, model, batcher)."""
    from repro_torch.core import ops
    from repro_torch.models import build_model

    print("[6s] serving grok-1-314b with Config.precision sparse24_int8 (same cut, same "
          "weights)")
    ops.clear_weight_cache()
    qcfg = dataclasses.replace(cfg, precision="sparse24_int8")
    model = build_model(qcfg)
    torch.cuda.reset_peak_memory_stats()
    run, batcher, _ = serve(torch, model, params, qcfg, "cuda_mx", n_req=16, gen=16,
                            label="grok sparse24_int8")
    run["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    run["sparse_payload_gib"] = _sparse_payload_gib(ops)
    _print_serve(run)
    print(f"      peak device memory {run['peak_memory_gib']:.2f} GiB, of which 2:4 int8 "
          f"payloads + metadata kept {run['sparse_payload_gib']:.2f} GiB; "
          f"{run['device_steps']} device steps; launches by variant {run['variants']}")
    _check_launches("grok sparse24_int8", run,
                    2 * cfg.n_layers * (run["device_steps"] + run["prefill_launches"]))
    _check_variant("grok sparse24_int8", run, "sparse", grouped=True,
                   dense_heads=run["device_steps"] + run["prefill_launches"])
    return run, model, batcher


def grok_abft_pass(torch, dev, cfg, model, params):
    """Phase 6a: a short grok-1 f32 pass (8 requests x 4 tokens) with
    abft=True -- the grouped GEMM's per-expert checksums -- against the same
    pass without: bitwise equal streams, no tile flagged."""
    print("[6a] grok-1-314b f32 with abft=True (grouped checksums)")
    runs = {}
    for abft in (True, False):
        runs[abft], _, _ = serve(torch, model, params, cfg, "cuda_mx", n_req=8, gen=4,
                                 label=f"grok {'abft' if abft else 'plain'} 8 x 4",
                                 abft=abft)
        _print_serve(runs[abft])
    run = runs[True]
    run["streams_equal_plain"] = run["streams"] == runs[False]["streams"]
    print(f"      abft counters {run['abft_stats']}, host audit {run['abft']}; streams "
          f"bitwise equal without ABFT: {run['streams_equal_plain']}; median step "
          f"{run['step_ms_median']:.2f} ms against {runs[False]['step_ms_median']:.2f} ms")
    _check_variant("grok abft", run, "abft", grouped=True)
    s = run["abft_stats"]
    if not (run["streams_equal_plain"] and s["tiles_flagged"] == 0 and s["gemms_verified"] > 0
            and run["abft"]["sdc_detected"] == 0):
        raise AssertionError(f"grok ABFT pass: {s} {run['abft']}")
    return dict(serve=run, plain=runs[False])


def grok_quant_holds(torch, dev, cfg, params, run, model, batcher):
    """Phase 7q: the grok int8 run's kernel path held against the plain path
    as in phase 7 (every GEMM call at 1e-3 * max|ref|, the logits as
    `_hold_logits` says), one decode step profiled, and a 64-token chunk
    (G = 16 routing groups) under "int8_tensor", whose activation scale is
    one amax per routing group."""
    from repro_torch.core import ops
    from repro_torch.models import build_model

    print("[7q] grok int8 kernel path against plain path")
    held = _hold_grok(torch, dev, model, params, model.cfg, batcher, "grok int8", quant=True)
    prof = _profile_grok(torch, dev, model, params, model.cfg, batcher,
                         "1 grok int8 decode step, 8 slots")
    ops.clear_weight_cache()
    tcfg = dataclasses.replace(cfg, precision="int8_tensor")
    print("    int8_tensor, the 64-token chunk (G = 16 routing groups):")
    held_t = _hold_grok(torch, dev, build_model(tcfg), params, tcfg, batcher,
                        "grok int8_tensor", steps=("prefill64",), quant=True)
    ops.clear_weight_cache()
    return dict(serve=run, hold=held, hold_int8_tensor=held_t, profile_decode=prof)


# ---------------------------------------------------------------------------
# phase 3 (this slice's kernels): ssd_scan and mx_flash_attention
# ---------------------------------------------------------------------------


def check_ssd(torch, dev, label, B, L, H, G, P, S, chunk, dtype_name, seed, reset=False):
    """`ssd_scan` against `ssd_scan_plain` on the same inputs.  The bound
    counts each input read once and y written once, and per chunk of q live
    rows and head q (q + 1) (S + P) operations for the lower triangles of
    C B^T and of the masked product times X (the decay mask zeroes the
    rest) plus 4 q S P for C h and the state update; no single PyTorch call
    computes the scan (library "none")."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import ssd_scan_plain
    from repro_torch.kernels.ssd_scan import ssd_scan

    dt = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(seed)

    def inputs():
        x = torch.randn((B, L, H, P), generator=g, device=dev).to(dt)
        a = -torch.rand((B, L, H), generator=g, device=dev) * 0.3
        if reset:  # a hard reset: the decay is masked before the exp
            a[:, L // 2] = -50.0
        b = (torch.randn((B, L, G, S), generator=g, device=dev) * 0.3).to(dt)
        c = (torch.randn((B, L, G, S), generator=g, device=dev) * 0.3).to(dt)
        return x, a, b, c

    args = inputs()
    got = ssd_scan(*args, chunk=chunk)
    ref = ssd_scan_plain(*args, chunk)
    torch.cuda.synchronize()
    err, tol = _err(torch, got, ref, dtype_name)
    nbytes = sum(t.numel() * t.element_size() for t in (*args, got))
    qs = [min(chunk, L - t) for t in range(0, L, chunk)]
    flops = B * H * sum(q * (q + 1) * (S + P) + 4 * q * S * P for q in qs)
    # the tensor-core route: every product as TF32 MMAs, three per product in
    # f32 (3xTF32); in bf16 one for C B^T (exact operands) and two for the rest
    mmas = (3, 3) if dtype_name == "float32" else (1, 2)
    route_flops = B * H * sum(mmas[0] * q * (q + 1) * S + mmas[1] * (q * (q + 1) * P
                                                                     + 4 * q * S * P)
                              for q in qs)
    sets = [args] + [inputs() for _ in range(_copies(nbytes) - 1)]
    t = _time_ms(torch, {"ms": (lambda *a: ssd_scan(*a, chunk=chunk), sets),
                         "plain_ms": (lambda *a: ssd_scan_plain(*a, chunk), sets)})
    bound, by = _bound_ms(nbytes, flops, dtype_name)
    tile = _build.ssd_tile(chunk, P, S, dt)
    return dict(kernel="ssd_scan", label=label, dtype=dtype_name, B=B, L=L, H=H, G=G, P=P,
                S=S, chunk=chunk, reset=reset, max_abs_err=err, tol=tol,
                finite=bool(torch.isfinite(got).all()), bytes=nbytes, flops=flops,
                bound_ms=bound, bound_by=by,
                route_bound_ms=_route_bound_ms(nbytes, route_flops),
                tile=dict(tile._asdict(), ctas=B * H), **t)


def check_flash(torch, dev, label, B, Lq, Lk, H, Hkv, d, causal, dtype_name, seed,
                f64=False):
    """`mx_flash_attention` against `flash_attention_plain`; the library
    yardstick is one `scaled_dot_product_attention` call on (B, H, L, d)
    views of the same tensors (never on the port's path).  Operations:
    4 B H Lq Lk d, halved by the causal mask.  `f64` (causal, Lq = Lk) also
    reads the kernel's and the plain version's max distance to the softmax
    in f64 (`tools/accumulation_witness.attention_f64`)."""
    import torch.nn.functional as F

    from repro_torch.kernels.mx_flash_attention import TILES, mx_flash_attention
    from repro_torch.kernels.ref import flash_attention_plain

    dt = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(seed)

    def inputs():
        return (torch.randn((B, Lq, H, d), generator=g, device=dev).to(dt),
                torch.randn((B, Lk, Hkv, d), generator=g, device=dev).to(dt),
                torch.randn((B, Lk, Hkv, d), generator=g, device=dev).to(dt))

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal,
            enable_gqa=H != Hkv).transpose(1, 2)

    args = inputs()
    got = mx_flash_attention(*args, causal=causal)
    ref = flash_attention_plain(*args, causal=causal)
    torch.cuda.synchronize()
    err, tol = _err(torch, got, ref, dtype_name)
    out = dict(kernel="mx_flash_attention", label=label, dtype=dtype_name, B=B, Lq=Lq,
               Lk=Lk, H=H, Hkv=Hkv, d=d, causal=causal, max_abs_err=err, tol=tol)
    if f64:
        from tools.accumulation_witness import attention_f64

        exact = attention_f64(torch, *args)
        out["f64_err"] = (got.double() - exact).abs().max().item()
        out["plain_f64_err"] = (ref.double() - exact).abs().max().item()
        del exact
    fns = {"ms": (lambda *a: mx_flash_attention(*a, causal=causal), None),
           "plain_ms": (lambda *a: flash_attention_plain(*a, causal=causal), None)}
    try:
        out["library_err"] = (library(*args).float() - ref.float()).abs().max().item()
        fns["library_ms"] = (library, None)
    except RuntimeError as e:  # a yardstick the installed PyTorch refuses
        out["library_error"] = str(e)
    nbytes = sum(t.numel() * t.element_size() for t in (*args, got))
    flops = (2 if causal else 4) * B * H * Lq * Lk * d
    sets = [args] + [inputs() for _ in range(_copies(nbytes) - 1)]
    out.update(_time_ms(torch, {k: (fn, sets) for k, (fn, _) in fns.items()}))
    out["bound_ms"], out["bound_by"] = _bound_ms(nbytes, flops, dtype_name)
    if dtype_name == "float32":  # the tensor-core route: three TF32 products
        out["route_bound_ms"] = _route_bound_ms(nbytes, 3 * flops)
    warps, stages = TILES[dt]
    out["tile"] = dict(warps=warps, stages=stages, ctas=B * H * -(-Lq // (16 * warps)))
    out.update(bytes=nbytes, flops=flops)
    return out


def check_flash_crafted(torch, dev):
    """The bf16 case where a probability rounded to bf16 before the PV
    product shows (k = [[0, 0], [1, 0]], v = I, q = [[0.0648, 0]]): JAX and
    the plain version give 0.48828125, a rounded probability 0.49023438; the
    kernel must equal the plain version exactly."""
    from repro_torch.kernels.mx_flash_attention import mx_flash_attention
    from repro_torch.kernels.ref import flash_attention_plain

    q = torch.tensor([[0.0648, 0.0]], device=dev).bfloat16()
    k = torch.tensor([[0.0, 0.0], [1.0, 0.0]], device=dev).bfloat16()
    v = torch.eye(2, device=dev).bfloat16()
    got = mx_flash_attention(q, k, v, causal=False)
    want = flash_attention_plain(q[None, :, None], k[None, :, None], v[None, :, None],
                                 causal=False)[0, :, 0]
    torch.cuda.synchronize()
    return dict(got=got.float().tolist(), plain=want.float().tolist(),
                exact=bool(torch.equal(got, want)))


def ssd_flash_checks(torch, dev):
    """Phase 3 for this slice's kernels, at the shapes of zamba2-2.7b's
    full forward (80 heads of P = 64, state 64, chunk 128; the shared
    block's 32 heads of d = 80) and the llama draft forward (32 / 8 heads,
    d = 64), plus a ragged L, a hard reset, the cross shape of
    tests/test_kernels_flash.py and bf16."""
    checks = [
        check_ssd(torch, dev, "zamba2 L=512", 8, 512, 80, 1, 64, 64, 128, "float32", 1),
        check_ssd(torch, dev, "zamba2 L=200 ragged", 8, 200, 80, 1, 64, 64, 128, "float32", 2),
        check_ssd(torch, dev, "hard reset", 2, 300, 8, 1, 64, 64, 128, "float32", 3,
                  reset=True),
        check_ssd(torch, dev, "zamba2 L=512 bf16", 8, 512, 80, 1, 64, 64, 128, "bfloat16", 4),
        check_flash(torch, dev, "zamba2 shared block", 8, 512, 512, 32, 32, 80, True,
                    "float32", 5, f64=True),
        check_flash(torch, dev, "llama draft", 4, 256, 256, 32, 8, 64, True, "float32", 6),
        check_flash(torch, dev, "cross", 1, 33, 70, 1, 1, 8, False, "float32", 7),
        check_flash(torch, dev, "zamba2 shared block bf16", 8, 512, 512, 32, 32, 80, True,
                    "bfloat16", 8),
        # phase 10's shapes: seamless-m4t-medium's encoder (non-causal, Lq = Lk)
        # and cross-attention (Lq < Lk; Lq = 1 at decode), internvl2-26b's
        # forward (d = 128, 48 / 8 heads, 1024 prefix + 64 text positions)
        check_flash(torch, dev, "seamless encoder", 4, 512, 512, 16, 16, 64, False,
                    "float32", 9),
        check_flash(torch, dev, "seamless cross", 4, 64, 512, 16, 16, 64, False, "float32",
                    10),
        check_flash(torch, dev, "seamless cross decode", 4, 1, 512, 16, 16, 64, False,
                    "float32", 11),
        check_flash(torch, dev, "seamless cross decode bf16", 4, 1, 512, 16, 16, 64, False,
                    "bfloat16", 12),
        check_flash(torch, dev, "internvl2 forward", 2, 1088, 1088, 48, 8, 128, True,
                    "float32", 13, f64=True),
        check_flash(torch, dev, "internvl2 forward bf16", 2, 1088, 1088, 48, 8, 128, True,
                    "bfloat16", 14),
    ]
    for c in checks:
        # the f32 attention's sums: as close to f64 as the plain version's,
        # within 2x (each k8 step's 3xTF32 products added with rounding FADDs)
        c["ok"] = (c["max_abs_err"] <= c["tol"] and c.get("finite", True)
                   and c.get("f64_err", 0.0) <= 2 * c.get("plain_f64_err", 0.0))
        if c["kernel"] == "ssd_scan":
            shape = f"B={c['B']} L={c['L']} H={c['H']} P={c['P']} S={c['S']} Q={c['chunk']}"
        else:
            shape = (f"B={c['B']} Lq={c['Lq']} Lk={c['Lk']} H={c['H']} Hkv={c['Hkv']} "
                     f"d={c['d']} {'causal' if c['causal'] else 'full'}")
        lib = "none" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
        extra = f" lib err {c['library_err']:.2e}" if "library_err" in c else ""
        if c.get("library_error"):
            extra += f" lib refused: {c['library_error'][:80]}"
        if "tile" in c and c["kernel"] == "ssd_scan":
            t = c["tile"]
            extra += (f" [{t['threads'] // 32} warps, {t['stages']} chunk slots, smem "
                      f"{t['smem']}, {t['ctas']} CTAs]")
        elif "tile" in c:
            t = c["tile"]
            extra += f" [{t['warps']} warps x 16 rows, {t['stages']} stages, {t['ctas']} CTAs]"
        if "route_bound_ms" in c:
            extra += f" TF32-route bound {c['route_bound_ms']:.4f}"
        if "f64_err" in c:
            extra += (f" to f64 {c['f64_err']:.3e} (plain {c['plain_f64_err']:.3e}, at most "
                      f"2x)")
        print(f"  {c['kernel']:18s} {c['dtype']:8s} {c['label']:24s} {shape:44s} err "
              f"{c['max_abs_err']:.3e} (tol {c['tol']:.3e}){extra} "
              f"{'ok' if c['ok'] else 'FAIL'}  ms {c['ms']:.4f} (spread "
              f"{100 * _spread(c):.0f}%) plain {c['plain_ms']:.4f} lib {lib} bound "
              f"{c['bound_ms']:.4f} ({c['bound_by']})")
    crafted = check_flash_crafted(torch, dev)
    print(f"  mx_flash_attention bf16 crafted (p kept in f32): kernel {crafted['got']} plain "
          f"{crafted['plain']} exact {crafted['exact']}")
    if not crafted["exact"]:
        raise AssertionError(f"the bf16 flash attention differs from the plain version on "
                             f"the crafted case: {crafted}")
    checks.append(dict(kernel="mx_flash_attention crafted", dtype="bfloat16", **crafted))
    bad = [c for c in checks if not c.get("ok", True)]
    if bad:
        raise AssertionError(f"{len(bad)} ssd_scan / flash attention check(s) disagree "
                             f"with the plain version: {bad}")
    return checks


# ---------------------------------------------------------------------------
# phases 8 and 9: dense-cache serving, zamba2-2.7b at full width
# ---------------------------------------------------------------------------


def serve_dense(torch, model, params, cfg, backend, n_req, gen, prompt_len, slots,
                label=None):
    """JAX's non-prefix launcher trace through the DENSE continuous batcher
    under `backend` (prompts stepped token by token, f32 cache).  Launch
    counts are set to 0 just before the run and read just after it."""
    from repro_torch import kernels
    from repro_torch.core import ops
    from repro_torch.launch.serve import make_trace
    from repro_torch.runtime.batcher import ContinuousBatcher

    with ops.use_policy(ops.MXPolicy(backend)):
        batcher = ContinuousBatcher(model, params, batch_slots=slots,
                                    max_len=prompt_len + gen, paged=False)
        reqs = make_trace(cfg, n_req, prompt_len, gen, prefix_cache=False)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for r in reqs:
            batcher.submit(r)
        finished = batcher.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        decode = kernels.decode_launch_counts()
        prefill_tile = kernels.prefill_launch_counts()
    step_dt = {h.step: h.dt_s for h in batcher.health}
    device_steps = [1e3 * h.dt_s for h in batcher.health if h.active > 0]
    ttft_steps = [r.first_token_at - r.submitted_at for r in finished.values()]
    ttft_ms = [1e3 * sum(step_dt[s] for s in range(r.submitted_at, r.first_token_at + 1))
               for r in finished.values()]
    generated = sum(len(r.output) for r in finished.values())
    out = dict(label=label or backend, backend=backend, requests=len(finished), slots=slots,
               prompt_len=prompt_len, gen=gen, wall_s=wall, steps=batcher.steps_run,
               device_steps=len(device_steps), generated_tokens=generated,
               generated_tok_per_s=generated / wall,
               total_tok_per_s=sum(len(r.prompt) + len(r.output)
                                   for r in finished.values()) / wall,
               ttft_steps_mean=sum(ttft_steps) / len(ttft_steps),
               ttft_steps_max=max(ttft_steps), ttft_ms_mean=sum(ttft_ms) / len(ttft_ms),
               ttft_ms_max=max(ttft_ms), step_ms_median=statistics.median(device_steps),
               finish_reasons=batcher.health_summary()["finish_reasons"], launches=counts,
               decode_launches=decode, prefill_tile_launches=prefill_tile,
               streams={r: finished[r].output for r in sorted(finished)},
               prompts={r: finished[r].prompt.tolist() for r in sorted(finished)})
    assert len(finished) == n_req, finished.keys()
    assert all(r.finish_reason == "max_new" and len(r.output) == gen
               for r in finished.values()), out["finish_reasons"]
    return out


def _print_dense(r):
    print(f"    [{r['label']}] {r['requests']} requests x {r['gen']} new tokens through "
          f"{r['slots']} dense slots: {r['wall_s']:.2f} s, {r['generated_tok_per_s']:.1f} "
          f"generated tok/s ({r['total_tok_per_s']:.1f} incl. prompt), {r['steps']} steps")
    print(f"      TTFT {r['ttft_steps_mean']:.1f} steps mean / {r['ttft_steps_max']} max, "
          f"{r['ttft_ms_mean']:.1f} ms mean / {r['ttft_ms_max']:.1f} ms max; median step "
          f"{r['step_ms_median']:.2f} ms; launches {r['launches']} (decode tile "
          f"{r['decode_launches']})")


def launcher(args, timeout=300):
    """`python -m repro_torch.launch.serve <args>` on the card in its own
    process; its output lines, required to exit 0."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                         capture_output=True, text=True, timeout=timeout,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    if out.returncode != 0:
        raise AssertionError(f"serve {' '.join(args)} exited {out.returncode}:\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    lines = out.stdout.strip().splitlines()
    print(f"    $ python -m repro_torch.launch.serve {' '.join(args)}  "
          f"({time.perf_counter() - t0:.1f} s with start-up)")
    for ln in lines:
        print(f"      {ln}")
    return lines


def dense_smoke_streams(torch, dev, names):
    """Smoke size, kernel path ("cuda_mx") against plain path ("torch"):
    each model of `names` through the dense batcher (llama also through the
    paged one), an encoder-decoder through the static launcher's greedy
    decode.  Returns, per name, whether every run's streams are equal, and
    the streams."""
    import argparse
    import io

    from repro_torch.configs import get_config
    from repro_torch.core import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import build_model
    from repro_torch.runtime.batcher import ContinuousBatcher

    out = {}
    for name in names:
        cfg = get_config(name)
        model = build_model(cfg)
        params = model.init(0, device=dev)
        modes = (("dense", {"paged": False}),)
        if "llama" in name:
            modes += (("paged", {"paged": True, "page_size": 4}),)
        for backend in ("cuda_mx", "torch"):
            with ops.use_policy(ops.MXPolicy(backend)), torch.no_grad():
                if cfg.model_kind == "encdec":
                    buf = io.StringIO()
                    args = argparse.Namespace(batch=3, prompt_len=12, gen=12, max_len=None,
                                              prefill_chunk=0)
                    with contextlib.redirect_stdout(buf):
                        serve_mod._run_static(model, cfg, params, args)
                    out[f"{name} {backend} static"] = [
                        ln for ln in buf.getvalue().splitlines() if ln.startswith("sample:")]
                    continue
                for mode, kw in modes:
                    b = ContinuousBatcher(model, params, batch_slots=3, max_len=32, **kw)
                    for r in serve_mod.make_trace(cfg, 7, 24, 8, prefix_cache=False):
                        b.submit(r)
                    fin = b.run_to_completion()
                    out[f"{name} {backend} {mode}"] = {r: fin[r].output for r in sorted(fin)}
    same = {}
    for name in names:
        runs = [v for k, v in out.items() if k.rsplit(" ", 2)[0] == name]
        same[name] = all(v == runs[0] for v in runs)
    return same, out


def llama_dense_phase(torch, dev, model, params, cfg):
    """Phase 9: llama3.2-1b at full width on the dense cache: a short trace
    through ContinuousBatcher(paged=False) and (paged=True), token-stepped
    both, on the kernel path; streams equal (a divergence passes only at a
    near tie of the plain logits -- the dense attention is plain PyTorch,
    the paged one the decode kernel); the static launcher with
    --prefill-chunk 64 in its own process."""
    from repro_torch.core import ops
    from repro_torch.launch.serve import make_trace
    from repro_torch.runtime.batcher import ContinuousBatcher

    print("[9] llama3.2-1b (full width) on the dense cache")
    dense = serve_dense(torch, model, params, cfg, "cuda_mx", n_req=8, gen=8, prompt_len=64,
                        slots=8, label="llama dense")
    _print_dense(dense)
    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        b = ContinuousBatcher(model, params, batch_slots=8, max_len=72, page_size=16)
        for r in make_trace(cfg, 8, 64, 8, prefix_cache=False):
            b.submit(r)
        fin = b.run_to_completion()
    paged = dict(streams={r: fin[r].output for r in sorted(fin)},
                 prompts=dense["prompts"])
    equal = sum(paged["streams"][r] == dense["streams"][r] for r in dense["streams"])
    div = divergences(torch, model, params, dense, paged)
    print(f"    dense streams equal to paged: {equal}/{len(dense['streams'])}; "
          f"divergences {div}")
    lines = launcher(["--arch", "llama3.2-1b", "--batch", "8", "--prompt-len", "128",
                      "--gen", "16", "--prefill-chunk", "64"])
    return dict(serve=dense, paged_streams=paged["streams"], streams_equal=equal,
                divergences=div, launcher=lines)


def _moved(tree, dev):
    """A nested dict of tensors, copied to `dev`."""
    return {k: _moved(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def _init_family(torch, dev, cfg):
    """The model of `cfg` and its f32 weights from seed 0 on the card, with
    the init time and the weights' size printed."""
    from repro_torch.models import build_model
    from repro_torch.models.modules import param_count

    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    out = dict(init_s=time.perf_counter() - t0, params_b=param_count(params) / 1e9,
               weights_gib=torch.cuda.memory_allocated() / 2**30)
    print(f"    init {out['init_s']:.1f} s, {out['params_b']:.3f} B params, weights "
          f"{out['weights_gib']:.2f} GiB")
    return model, params, out


def _forward_pair(torch, step, params, batch, warm):
    """`step(params, batch)` (a `launch.steps` builder's closure) on the
    kernel path, then the plain path, each after one warm-up call on
    `warm`: host ms of the call (ending in a synchronize), its launches
    (counts set to 0 just before it), and the logits held at 1e-3 *
    max|ref|.  The plain path must launch nothing."""
    from repro_torch import kernels
    from repro_torch.core import ops

    fwd = {}
    for backend in ("cuda_mx", "torch"):
        with ops.use_policy(ops.MXPolicy(backend)), torch.no_grad():
            step(params, warm)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            logits = step(params, batch)
            torch.cuda.synchronize()
            fwd[backend] = dict(ms=(time.perf_counter() - t0) * 1e3, logits=logits,
                                launches=kernels.launch_counts(),
                                decode_launches=kernels.decode_launch_counts(),
                                prefill_tile_launches=kernels.prefill_launch_counts())
    held = _hold_logits(torch, fwd["cuda_mx"]["logits"], fwd["torch"]["logits"], None, 1e-3)
    if any(fwd["torch"]["launches"].values()):
        raise AssertionError(f"the plain path launched kernels: {fwd['torch']['launches']}")
    return fwd, held


def _decode_held(torch, step_fn, n, ref, want_fused=None, want_attn=None):
    """n decode steps (`step_fn(t)` -> logits (B, 1, V)) on the kernel path
    against `ref` (B, >= n, V), the forward's logits, at 1e-3 * max|ref|;
    per step the launches (counts set to 0 just before it), required at
    `want_fused` mx_matmul_fused launches, all on the decode tile, and
    `want_attn` mx_flash_attention launches where given."""
    from repro_torch import kernels
    from repro_torch.core import ops

    steps, per_step = [], []
    with ops.use_policy(ops.MXPolicy("cuda_mx")), torch.no_grad():
        for t in range(n):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            steps.append(step_fn(t))
            torch.cuda.synchronize()
            per_step.append(dict(launches=kernels.launch_counts(),
                                 decode=kernels.decode_launch_counts()))
    held = _hold_logits(torch, torch.cat(steps, dim=1), ref[:, :n], None, 1e-3)
    fused = {s["launches"]["mx_matmul_fused"] for s in per_step}
    decode = {s["decode"]["mx_matmul_fused"] for s in per_step}
    attn = {s["launches"]["mx_flash_attention"] for s in per_step}
    print(f"    {n} decode steps against the forward's logits: err {held['max_abs_err']:.3e} "
          f"(tol {held['tol']:.3e}) argmax equal {held['argmax_equal']}; per step "
          f"mx_matmul_fused {sorted(fused)} (decode tile {sorted(decode)}), "
          f"mx_flash_attention {sorted(attn)}")
    if not held["ok"]:
        raise AssertionError(f"decode disagrees with the forward: {held}")
    if want_fused is not None and (fused != {want_fused} or decode != {want_fused}):
        raise AssertionError(f"want {want_fused} mx_matmul_fused launches per decode step, "
                             f"all on the decode tile: {per_step}")
    if want_attn is not None and attn != {want_attn}:
        raise AssertionError(f"want {want_attn} mx_flash_attention launches per decode "
                             f"step: {per_step}")
    total = {k: sum(s["launches"][k] for s in per_step) for k in per_step[0]["launches"]}
    return dict(hold=held, per_step=per_step[0], launches=total)


def _print_forward(what, fwd, held):
    print(f"    {what}: kernel path {fwd['cuda_mx']['ms']:.1f} ms, plain path "
          f"{fwd['torch']['ms']:.1f} ms (host clock, one call each after a warm-up); "
          f"launches {fwd['cuda_mx']['launches']} (prefill tile "
          f"{fwd['cuda_mx']['prefill_tile_launches']})")
    print(f"    logits against the plain path: err {held['max_abs_err']:.3e} (tol "
          f"{held['tol']:.3e}) argmax equal {held['argmax_equal']}")
    if not held["ok"]:
        raise AssertionError(f"{what}: the kernel path disagrees with the plain path: {held}")


def zamba2_phase(torch, dev):
    """Phase 8: zamba2-2.7b at full width (54 Mamba2 layers, d_model 2560,
    the shared block after every 6; nothing cut), f32 weights from seed 0.
    Returns the results, the model and its weights parked in host memory
    for the profile that ends the run (off the card while llama and grok
    run, so their peak memory is theirs alone)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step

    cfg = get_config("zamba2-2.7b")
    n_mamba = sum(n for kind, n in cfg.blocks if kind == "mamba2")
    n_shared = n_mamba // cfg.shared_attn_every
    print(f"[8] zamba2-2.7b (f32, full width: {n_mamba} Mamba2 layers, shared block every "
          f"{cfg.shared_attn_every}, d_model {cfg.d_model}; nothing cut)")
    model, params, init = _init_family(torch, dev, cfg)
    # the cacheless prefill step: the full forward on 4 x 512 tokens
    toks = torch.randint(0, cfg.vocab, (4, 512), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    fwd, held = _forward_pair(torch, make_prefill_step(model, cfg), params, {"tokens": toks},
                              {"tokens": toks[:1, :64]})
    _print_forward("full forward 4 x 512 tokens", fwd, held)
    launches = fwd["cuda_mx"]["launches"]
    if launches["ssd_scan"] != n_mamba or launches["mx_flash_attention"] != n_shared:
        raise AssertionError(f"zamba2 forward: want {n_mamba} ssd_scan and {n_shared} "
                             f"mx_flash_attention launches, got {launches}")
    # 16 tokens stepped through decode_step from an empty dense cache
    ref = fwd["cuda_mx"]["logits"]
    cache = model.make_cache(4, 16, dtype=torch.float32, device=dev)
    dec = _decode_held(torch, lambda t: model.decode_step(params, toks[:, t:t + 1], cache,
                                                          t)[0], 16, ref)
    del cache, ref
    for fw in fwd.values():
        fw.pop("logits")
    gc.collect()
    torch.cuda.empty_cache()
    # JAX's non-prefix trace through the dense batcher, kernel then plain path
    runs = {}
    for backend in ("cuda_mx", "torch"):
        runs[backend] = serve_dense(torch, model, params, cfg, backend, n_req=16, gen=16,
                                    prompt_len=128, slots=8, label=f"zamba2 dense {backend}")
        _print_dense(runs[backend])
    equal = sum(runs["cuda_mx"]["streams"][r] == runs["torch"]["streams"][r]
                for r in runs["torch"]["streams"])
    # its decode steps' projections (M = 8 slots) run the decode tile
    if runs["cuda_mx"]["decode_launches"]["mx_matmul_fused"] <= 0:
        raise AssertionError(f"zamba2 dense batcher: no decode tile launch "
                             f"{runs['cuda_mx']['decode_launches']}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"    full-width streams equal across cuda_mx / torch: {equal}/16 (recorded); "
          f"peak device memory {peak:.2f} GiB")
    params = _moved(params, "cpu")
    gc.collect()
    torch.cuda.empty_cache()
    same, streams = dense_smoke_streams(torch, dev, ("zamba2-2.7b-smoke", "llama3.2-1b-smoke"))
    print(f"    smoke-size dense streams equal across backends (and llama dense = paged): "
          f"{same}")
    if not all(same.values()):
        raise AssertionError(f"dense smoke streams differ: {streams}")
    lines = launcher(["--arch", "zamba2-2.7b", "--batch", "8", "--prompt-len", "64",
                      "--gen", "16"])
    return dict(init, peak_memory_gib=peak, forward=fwd, hold_forward=held, decode=dec,
                serve=runs, streams_equal=equal, smoke_streams=streams, launcher=lines,
                launches=dict(ssd_scan=launches["ssd_scan"],
                              mx_flash_attention=launches["mx_flash_attention"])), \
        model, params


def zamba2_profile(torch, dev, model, params):
    """One zamba2-2.7b decode step at 8 slots and one full forward (4 x 512
    tokens) on the kernel path, profiled (last: a profiler session slows
    later launches of the process), with phase 8's weights."""
    from repro_torch.core import ops
    from repro_torch.launch.steps import make_prefill_step

    cfg = model.cfg
    params = _moved(params, dev)
    cache = model.make_cache(8, 144, dtype=torch.float32, device=dev)
    tok = torch.randint(0, cfg.vocab, (8, 1), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    index = torch.arange(8, device=dev) * 16
    with ops.use_policy(ops.MXPolicy("cuda_mx")), torch.no_grad():
        prof = _profile(torch, lambda: model.decode_step(params, tok, cache, index))
    _print_profile("1 zamba2 decode step, 8 dense slots", prof)
    del cache
    # the full forward of phase 8 (4 x 512 tokens): its 9 flash attention calls
    toks = torch.randint(0, cfg.vocab, (4, 512), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    prefill = make_prefill_step(model, cfg)
    with ops.use_policy(ops.MXPolicy("cuda_mx")), torch.no_grad():
        fwd = _profile(torch, lambda: prefill(params, {"tokens": toks}))
    _print_profile("1 zamba2 full forward, 4 x 512 tokens", fwd)
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return prof, fwd


# ---------------------------------------------------------------------------
# phase 10: the xLSTM, encoder-decoder and prefix-embedding families
# ---------------------------------------------------------------------------


def _plain_f64(torch, step, params, batch):
    """`step(params, batch)` on the plain path in float64 (weights, states
    and GEMMs; tools/accumulation_witness.plain_f64): the witness both f32
    paths are measured against."""
    from tools.accumulation_witness import plain_f64, widened

    with plain_f64(torch):
        out = step(widened(params), batch)
    if out.dtype != torch.float64:
        raise AssertionError(f"the f64 witness ran in {out.dtype}")
    return out


def _static_in_process(torch, model, cfg, params, batch, prompt_len, gen):
    """The launcher's static path (`serve._run_static`) in this process, on
    a model built here (a depth-cut config, which the launcher's command
    line cannot build); its printed lines."""
    import argparse
    import io

    from repro_torch.launch import serve as serve_mod

    args = argparse.Namespace(batch=batch, prompt_len=prompt_len, gen=gen, max_len=None,
                              prefill_chunk=0)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), torch.no_grad():
        serve_mod._run_static(model, cfg, params, args)
    lines = buf.getvalue().strip().splitlines()
    print(f"    launch.serve._run_static(batch {batch}, prompt {prompt_len}, gen {gen}) in this "
          f"process ({time.perf_counter() - t0:.1f} s)")
    for ln in lines:
        print(f"      {ln}")
    return lines


def xlstm_phase(torch, dev):
    """Phase 10, xlstm-125m at full width (nothing cut): the forward on 4 x
    512 tokens, kernel path against plain path, both against the plain path
    in f64; 16 decode steps against it (51 mx_matmul_fused launches a step,
    all on the decode tile), the dense batcher on JAX's non-prefix trace on
    both paths, and the static launcher in its own process."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step

    cfg = get_config("xlstm-125m")
    kinds = [k for k, n in cfg.blocks for _ in range(n)]
    n_m, n_s = kinds.count("mlstm"), kinds.count("slstm")
    print(f"[10] xlstm-125m (f32, full width: {n_m} mLSTM + {n_s} sLSTM blocks, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, vocab {cfg.vocab}, tied; nothing cut)")
    t_phase = time.perf_counter()
    model, params, init = _init_family(torch, dev, cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (4, 512), device=dev, generator=g)
    step = make_prefill_step(model, cfg)
    fwd, held = _forward_pair(torch, step, params, {"tokens": toks}, {"tokens": toks[:1, :64]})
    _print_forward("full forward 4 x 512 tokens", fwd, held)
    # the witness: both f32 paths against the plain path in f64; the kernel
    # path may stand no more than twice as far from it as the plain path
    exact = _plain_f64(torch, step, params, {"tokens": toks})
    held["f64_err"] = (fwd["cuda_mx"]["logits"].double() - exact).abs().max().item()
    held["plain_f64_err"] = (fwd["torch"]["logits"].double() - exact).abs().max().item()
    del exact
    print(f"    logits against the plain path in f64: kernel path {held['f64_err']:.3e}, plain "
          f"path {held['plain_f64_err']:.3e} (the kernel path within 2x the plain path's)")
    if held["f64_err"] > 2 * held["plain_f64_err"]:
        raise AssertionError(f"xlstm forward: the kernel path is {held['f64_err']:.3e} from the "
                             f"f64 forward, the plain path {held['plain_f64_err']:.3e}")
    want = 5 * n_m + 2 * n_s
    if (fwd["cuda_mx"]["launches"]["mx_matmul_fused"] != want
            or fwd["cuda_mx"]["prefill_tile_launches"]["mx_matmul_fused"] != want):
        raise AssertionError(f"xlstm forward: want {want} mx_matmul_fused launches on the "
                             f"prefill tile, got {fwd['cuda_mx']}")
    ref = fwd["cuda_mx"]["logits"]
    cache = model.make_cache(4, 16, dtype=torch.float32, device=dev)
    dec = _decode_held(torch, lambda t: model.decode_step(params, toks[:, t:t + 1], cache,
                                                          t)[0],
                       16, ref, want_fused=want, want_attn=0)
    del cache, ref
    for fw in fwd.values():
        fw.pop("logits")
    gc.collect()
    torch.cuda.empty_cache()
    runs = {}
    for backend in ("cuda_mx", "torch"):
        runs[backend] = serve_dense(torch, model, params, cfg, backend, n_req=16, gen=16,
                                    prompt_len=128, slots=8, label=f"xlstm dense {backend}")
        _print_dense(runs[backend])
    equal = sum(runs["cuda_mx"]["streams"][r] == runs["torch"]["streams"][r]
                for r in runs["torch"]["streams"])
    if runs["cuda_mx"]["decode_launches"]["mx_matmul_fused"] <= 0:
        raise AssertionError(f"xlstm dense batcher: no decode tile launch {runs['cuda_mx']}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"    full-width streams equal across cuda_mx / torch: {equal}/16 (recorded); "
          f"peak device memory {peak:.2f} GiB")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    lines = launcher(["--arch", "xlstm-125m", "--batch", "8", "--prompt-len", "64",
                      "--gen", "16"])
    seconds = time.perf_counter() - t_phase
    print(f"    phase 10 xlstm-125m: {seconds:.1f} s")
    return dict(init, forward=fwd, hold_forward=held, decode=dec, serve=runs,
                streams_equal=equal, peak_memory_gib=peak, launcher=lines, seconds=seconds,
                launches=fwd["cuda_mx"]["launches"])


def seamless_phase(torch, dev):
    """Phase 10, seamless-m4t-medium at full width (nothing cut): the
    forward on 4 x 512 frames + 4 x 512 tokens (36 mx_flash_attention
    launches: 12 encoder, 12 causal decoder, 12 cross), 16 decode steps
    against the encoder output (12 cross-attention launches a step), and
    the static launcher in its own process."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    cfg = get_config("seamless-m4t-medium")
    print(f"[10] seamless-m4t-medium (f32, full width: {cfg.enc_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim}, {cfg.activation} d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied; "
          f"nothing cut)")
    t_phase = time.perf_counter()
    model, params, init = _init_family(torch, dev, cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randn((4, 512, cfg.frontend_dim), device=dev, generator=g) * 0.1
    toks = torch.randint(0, cfg.vocab, (4, 512), device=dev, generator=g)
    fwd, held = _forward_pair(torch, make_prefill_step(model, cfg), params,
                              {"frames": frames, "tokens": toks},
                              {"frames": frames[:1, :64], "tokens": toks[:1, :64]})
    _print_forward("full forward 4 x (512 frames + 512 tokens)", fwd, held)
    want = cfg.enc_layers + 2 * cfg.n_layers
    if fwd["cuda_mx"]["launches"]["mx_flash_attention"] != want:
        raise AssertionError(f"seamless forward: want {want} mx_flash_attention launches, "
                             f"got {fwd['cuda_mx']['launches']}")
    ref = fwd["cuda_mx"]["logits"]
    with torch.no_grad():
        enc_out = model.encode(params, frames)
    step = make_serve_step(model, cfg)
    cache = model.make_cache(4, 16, dtype=torch.float32, device=dev)
    dec = _decode_held(torch, lambda t: step(params, cache, toks[:, t:t + 1], t, enc_out)[0],
                       16, ref, want_attn=cfg.n_layers)
    del cache, ref, enc_out
    for fw in fwd.values():
        fw.pop("logits")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"    peak device memory {peak:.2f} GiB")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    lines = launcher(["--arch", "seamless-m4t-medium", "--batch", "8", "--prompt-len", "64",
                      "--gen", "16"])
    seconds = time.perf_counter() - t_phase
    print(f"    phase 10 seamless-m4t-medium: {seconds:.1f} s")
    return dict(init, forward=fwd, hold_forward=held, decode=dec, peak_memory_gib=peak,
                launcher=lines, seconds=seconds, launches=fwd["cuda_mx"]["launches"])


def internvl2_phase(torch, dev):
    """Phase 10, internvl2-26b at full width, its depth cut from 48 to 8
    layers (48 are 79.5 GB in f32): the prefill step on 2 x (1024 prefix
    embeddings + 64 tokens) held on the text positions, then text only as
    JAX serves it: the static launcher's path in this process and the
    dense batcher on both paths."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step

    full = get_config("internvl2-26b")
    cfg = dataclasses.replace(full, n_layers=8, blocks=(("dense", 8),))
    print(f"[10] internvl2-26b (f32, full width: d_model {cfg.d_model}, {cfg.n_heads} / "
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"untied, frontend {cfg.frontend_dim} x {cfg.frontend_tokens} tokens); depth cut: "
          f"n_layers {full.n_layers} -> {cfg.n_layers} ({full.n_params() * 4 / 1e9:.1f} GB "
          f"of f32 weights at full depth)")
    t_phase = time.perf_counter()
    model, params, init = _init_family(torch, dev, cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 64), device=dev, generator=g),
             "pixel_embeds": torch.randn((2, cfg.frontend_tokens, cfg.frontend_dim),
                                         device=dev, generator=g)}
    warm = {"tokens": batch["tokens"][:1, :8], "pixel_embeds": batch["pixel_embeds"][:1]}
    fwd, held = _forward_pair(torch, make_prefill_step(model, cfg), params, batch, warm)
    _print_forward(f"prefill step 2 x ({cfg.frontend_tokens} prefix + 64 tokens), the text "
                   f"positions", fwd, held)
    if fwd["cuda_mx"]["launches"]["mx_flash_attention"] != cfg.n_layers:
        raise AssertionError(f"internvl2 prefill: want {cfg.n_layers} mx_flash_attention "
                             f"launches, got {fwd['cuda_mx']['launches']}")
    for fw in fwd.values():
        fw.pop("logits")
    gc.collect()
    torch.cuda.empty_cache()
    lines = _static_in_process(torch, model, cfg, params, 8, 64, 16)
    runs = {}
    for backend in ("cuda_mx", "torch"):
        runs[backend] = serve_dense(torch, model, params, cfg, backend, n_req=16, gen=16,
                                    prompt_len=128, slots=8, label=f"internvl2 dense {backend}")
        _print_dense(runs[backend])
    equal = sum(runs["cuda_mx"]["streams"][r] == runs["torch"]["streams"][r]
                for r in runs["torch"]["streams"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"    full-width streams equal across cuda_mx / torch: {equal}/16 (recorded); "
          f"peak device memory {peak:.2f} GiB")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"    phase 10 internvl2-26b: {seconds:.1f} s")
    return dict(init, config=dict(n_layers=cfg.n_layers, cut_from=full.n_layers),
                forward=fwd, hold_forward=held, launcher=lines, serve=runs,
                streams_equal=equal, peak_memory_gib=peak, seconds=seconds,
                launches=fwd["cuda_mx"]["launches"])


def family_phases(torch, dev):
    """Phase 10: each family at full width, each model freed before the
    next, then the smoke streams across backends."""
    out = dict(xlstm=xlstm_phase(torch, dev), seamless=seamless_phase(torch, dev),
               internvl2=internvl2_phase(torch, dev))
    t0 = time.perf_counter()
    same, streams = dense_smoke_streams(
        torch, dev, ("xlstm-125m-smoke", "internvl2-26b-smoke", "seamless-m4t-medium-smoke"))
    print(f"    smoke-size streams equal across backends: {same} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not all(same.values()):
        raise AssertionError(f"family smoke streams differ: {streams}")
    out["smoke_streams"] = streams
    return out


# ---------------------------------------------------------------------------
# phase 11: disaggregated serving, chaos and the non-finite quarantine
# ---------------------------------------------------------------------------

# event kinds that mark a request a fault touched: its rows may have been
# recomputed in chunks of another height (the other dense tile, other bits)
TOUCHED = ("chaos_", "worker_lost", "handoff_reroute", "handoff_fallback_decode",
           "degraded_forward", "quarantined", "preempted", "resumed")
# phase 11c's deterministic worker faults on top of the launcher's mix: a kill,
# a hang and a window of dropped handoffs long enough for a reroute (a handoff
# staged at s drops at s, s + 1, s + 3, s + 7)
DISAGG_SCHEDULE = dict(kill_worker_at=((12, 0),), hang_worker_at=((3, 1, 4),),
                       drop_handoff_at=tuple(range(5, 13)))


def serve11(torch, target, reqs, label):
    """Submit `reqs` to `target` (a ContinuousBatcher or a DisaggEngine) and
    run it to completion; the launch counts (and the ABFT counters) are set
    to 0 just before the run and read just after it."""
    from repro_torch import kernels
    from repro_torch.kernels import abft as abft_mod

    batcher = getattr(target, "batcher", target)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    abft_mod.reset_abft_stats()
    t0 = time.perf_counter()
    for r in reqs:
        target.submit(r)
    fin = target.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    admit = {at for r in fin.values() for kind, at in r.events if kind in ("admitted", "resumed")}
    spikes = {}
    if batcher.chaos is not None:  # synthetic watchdog seconds, not step time
        spikes = {e.step: batcher.chaos.cfg.latency_spike_s
                  for e in batcher.chaos.events if e.kind == "latency_spike"}
    steps = [1e3 * (h.dt_s - spikes.get(h.step, 0.0)) for h in batcher.health
             if h.active and h.step not in admit]
    generated = sum(len(r.output) for r in fin.values())
    return dict(
        label=label, requests=len(fin), wall_s=wall, steps=batcher.steps_run,
        generated_tok_per_s=generated / wall,
        step_ms_median=statistics.median(steps) if steps else None, steps_timed=len(steps),
        launches=kernels.launch_counts(), variants=kernels.variant_launch_counts(),
        decode=kernels.decode_launch_counts(), prefill_tile=kernels.prefill_launch_counts(),
        abft_stats=abft_mod.abft_stats(), health=batcher.health_summary(),
        streams={r: fin[r].output for r in sorted(fin)},
        prompts={r: fin[r].prompt.tolist() for r in sorted(fin)},
        reasons={r: fin[r].finish_reason for r in sorted(fin)},
        touched=sorted(r for r in fin if any(k.startswith(TOUCHED) for k, _ in fin[r].events)),
        poisoned=sorted(rid for h in batcher.health for rid in h.poisoned),
        chaos=batcher.chaos.summary() if batcher.chaos else None,
        summary=target.summary() if hasattr(target, "summary") else None)


def hold11(torch, model, params, ref, run, strict):
    """`run`'s streams against `ref`'s: a differing stream is reported with
    its first differing step and the reference's top-2 logit gap there, and
    passes only below phase 5's tolerance (1e-3 * max|logit|); with
    `strict`, a stream no fault touched must equal its reference."""
    div = divergences(torch, model, params, ref, run)
    for d in div:
        d["touched"] = d["rid"] in run["touched"]
    run["divergences"] = div
    run["streams_equal"] = sum(run["streams"][r] == ref["streams"][r] for r in run["streams"])
    print(f"      streams equal to [{ref['label']}]: {run['streams_equal']}/"
          f"{len(run['streams'])}; touched by faults {run['touched']}; divergences {div}")
    bad = [d for d in div if d["top2_gap"] >= d["tol"] or (strict and not d["touched"])]
    if bad:
        raise AssertionError(f"{run['label']}: streams leave [{ref['label']}] away from a "
                             f"near tie, or untouched by the faults: {bad}")
    short = [r for r, reason in run["reasons"].items()
             if reason != "failed" and len(run["streams"][r]) != len(ref["streams"][r])]
    if short:
        raise AssertionError(f"{run['label']}: requests {short} ended early: {run['reasons']}")


def print11(r):
    print(f"    [{r['label']}] {r['requests']} requests: {r['wall_s']:.2f} s, "
          f"{r['generated_tok_per_s']:.1f} generated tok/s, {r['steps']} batcher steps, median "
          f"step without admission {r['step_ms_median'] or float('nan'):.2f} ms "
          f"({r['steps_timed']} steps); finish {r['health']['finish_reasons']}")
    print(f"      launches {r['launches']} (decode tile {r['decode']}; prefill tile "
          f"{r['prefill_tile']}; variants {r['variants']})")
    if r["summary"]:
        s = {k: v for k, v in r["summary"].items() if k not in ("workers", "batcher")}
        print(f"      engine {s}; workers " + ", ".join(
            f"w{w['wid']}={w['state']}{'(suspected)' if w['suspected'] else ''} x{w['launches']}"
            for w in r["summary"]["workers"]))
    h = r["health"]
    if r["chaos"]:
        print(f"      chaos {r['chaos']}; retries {h['retries']}, preemptions "
              f"{h['preemptions']} / resumes {h['resumes']}, quarantined {h['quarantined']} "
              f"(poisoned rids {r['poisoned']}), abft {h['abft']}")


def _check11(label, run, decode=True, verify=False, abft=False):
    """The kernels phase 11's `run` must launch: the MX GEMM on the prefill
    tile (chunks of more than 16 rows) and, for the decode steps and the
    shorter chunks, on the decode tile, or its ABFT variant under
    abft=True (which checksums decode and verify steps, not prefill
    chunks); the paged decode (or verify) attention; no baseline, grouped
    or other attention kernel."""
    n, ok = run["launches"], run["prefill_tile"]["mx_matmul_fused"] > 0
    ok &= run["decode"]["mx_matmul_fused"] > 0 or abft
    ok &= (n["mx_flash_decode"] > 0) == decode and (n["mx_flash_verify"] > 0) == verify
    ok &= (run["variants"]["mx_matmul_fused abft"] > 0) == abft
    ok &= not (n["baseline_matmul"] or n["mx_grouped_matmul"] or n["ssd_scan"]
               or n["mx_flash_attention"])
    if not ok:
        raise AssertionError(f"{label}: unexpected kernel launches {n}, {run['variants']}, "
                             f"decode tile {run['decode']}, prefill tile {run['prefill_tile']}")


def guard_parts(torch, dev, shape, calls=20):
    """The non-finite guard's two parts on (B, vocab) f32 logits on the
    card, each the median of `calls` host-timed calls: the device-to-host
    copy (`ContinuousBatcher._to_host`) and the host's finite flags."""
    from repro_torch.runtime.batcher import ContinuousBatcher

    x = torch.randn(shape, device=dev)
    host = ContinuousBatcher._to_host(x)
    out = {}
    for name, fn in (("copy_ms", lambda: ContinuousBatcher._to_host(x)),
                     ("isfinite_ms", lambda: torch.isfinite(host).all(dim=-1).numpy())):
        times = []
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        out[name] = statistics.median(times)
    return out


def _bytes(tree):
    return sum(t.numel() * t.element_size() for seg in tree.values() for t in seg.values())


def phase11(torch, dev, then=None):
    """Phase 11: llama3.2-1b at full width (f32, seed 0, nothing cut) through
    the disaggregated engine (shared pool, migration, under chaos) and the
    paged batcher under chaos with ABFT, plain and speculative; then
    `then(model, params, cfg)` on the same weights (phase 12).  Returns
    (phase 11's record, then's)."""
    from repro_torch.configs import get_config
    from repro_torch.core import ops
    from repro_torch.launch.serve import (
        batcher_faults, disagg_faults, make_disagg_trace, make_trace, stagger,
    )
    from repro_torch.models import build_model
    from repro_torch.models.modules import param_count
    from repro_torch.runtime.batcher import ContinuousBatcher
    from repro_torch.runtime.disagg import DisaggEngine
    from repro_torch.runtime.lifecycle import ChaosConfig, ChaosInjector, RetryPolicy
    from repro_torch.runtime.speculative import NGramDrafter

    t_phase = time.perf_counter()
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    params = model.init(0, device=dev)
    weights = 4 * param_count(params)
    out = {}
    prompt_len, gen, ps, chunk = 128, 16, 16, 64
    max_len = prompt_len + gen
    retry = RetryPolicy(max_retries=3, backoff_s=0.0)
    with ops.use_policy(ops.MXPolicy("cuda_mx")), torch.no_grad():
        print("[11a] disaggregated serving, shared pool: 2 prefill workers -> 4 decode slots, "
              "the launcher's trace at --prompt-len 128 --gen 16")
        plain = ContinuousBatcher(model, params, batch_slots=4, max_len=max_len, page_size=ps,
                                  prefill_chunk=chunk)
        ref = serve11(torch, plain, make_disagg_trace(cfg, 16, prompt_len, gen),
                      "plain paged batcher")
        print11(ref)
        del plain

        def engine(**kw):
            return DisaggEngine(model, params, prefill_workers=2, batch_slots=4,
                                max_len=max_len, page_size=ps, prefill_chunk=chunk,
                                retry=retry, **kw)

        reqs = make_disagg_trace(cfg, 16, prompt_len, gen)
        full = {r.rid: (len(r.prompt) - 1) // ps for r in reqs}
        eng = engine()
        shared = serve11(torch, eng, reqs, "disagg shared pool")
        shared["pages_published"] = sum(full.values())
        shared["index"] = eng.index_p.stats()
        print11(shared)
        print(f"      pages published by the handoffs {shared['pages_published']} (index "
              f"{shared['index']['entries']} pages pinned after dedup)")
        hold11(torch, model, params, ref, shared, strict=False)
        _check11("11a", shared)
        if shared["summary"]["handoffs_completed"] != 16 or shared["summary"]["migrated_pages"]:
            raise AssertionError(f"11a: {shared['summary']}")
        out["11a"], out["11a_ref"] = shared, ref
        del eng

        print("[11b] the same with shared_pool=False: pages migrate into the decode pool")
        eng = engine(shared_pool=False)
        held = []
        migrate = eng._migrate_pages

        def checked(dst, src):
            migrate(dst, src)
            held.append(all(torch.equal(t[:, dst], eng.cache_p[name][leaf][:, src])
                            for name, seg in eng.batcher.cache.items()
                            for leaf, t in seg.items()))

        eng._migrate_pages = checked
        print(f"      prefill cache {_bytes(eng.cache_p) / 1e9:.3f} GB ("
              f"{eng.pool_p.total_pages} pages), decode cache "
              f"{_bytes(eng.batcher.cache) / 1e9:.3f} GB, beside {weights / 1e9:.3f} GB of f32 "
              f"weights; {torch.cuda.mem_get_info()[0] / 1e9:.1f} GB free on the card")
        mig = serve11(torch, eng, make_disagg_trace(cfg, 16, prompt_len, gen),
                      "disagg page migration")
        # the rule of tests/test_disagg.py: every full page of each prompt but
        # its last token, over the requests that went through a worker
        want = sum(n for r, n in full.items()
                   if any(k == "handoff" for k, _ in eng.finished[r].events))
        mig["migrations_bitwise"] = held
        print11(mig)
        print(f"      migrated pages {mig['summary']['migrated_pages']} (want {want}); "
              f"{len(held)} migrations, each bitwise its source pages: {all(held)}")
        hold11(torch, model, params, ref, mig, strict=False)
        _check11("11b", mig)
        if mig["summary"]["migrated_pages"] != want or not held or not all(held):
            raise AssertionError(f"11b: migrated {mig['summary']['migrated_pages']} of {want}, "
                                 f"bitwise {held}")
        out["11b"] = mig
        del eng

        print("[11c] 11a under chaos: the launcher's disagg fault mix at --fault-rate 0.2 "
              f"and {DISAGG_SCHEDULE}")
        chaos = ChaosInjector(ChaosConfig(seed=0, **disagg_faults(0.2), **DISAGG_SCHEDULE))
        eng = engine(chaos=chaos)
        hurt = serve11(torch, eng, make_disagg_trace(cfg, 16, prompt_len, gen), "disagg chaos")
        print11(hurt)
        hold11(torch, model, params, shared, hurt, strict=True)
        _check11("11c", hurt)
        s, c = hurt["summary"], hurt["chaos"]
        if not (c["worker_kills_injected"] and s["recoveries"] and c["worker_hangs_injected"]
                and s["handoff_drops"] and s["reroutes"]) \
                or set(hurt["reasons"].values()) != {"max_new"}:
            raise AssertionError(f"11c: the schedule missed a fault, or a request failed: {s}")
        out["11c"] = hurt
        del eng

        print("[11d] the paged batcher on phase 4's trace with chaos and abft=True: the "
              "launcher's fault mix at --fault-rate 0.1, bit flips on")

        def trace4(n_req=16, new=32):
            reqs = make_trace(cfg, n_req, prompt_len, new, prefix_cache=True)
            stagger(reqs, prompt_len, new)  # as the launcher does under --chaos
            return reqs

        def batcher(slots=8, new=32, **kw):
            ml = prompt_len + new
            return ContinuousBatcher(model, params, batch_slots=slots, max_len=ml,
                                     page_size=ps, num_pages=(slots + 2) * -(-ml // ps),
                                     prefix_cache=True, prefill_chunk=chunk, retry=retry, **kw)

        base = serve11(torch, batcher(), trace4(), "batcher fault-free")
        guard = serve11(torch, batcher(nonfinite_guard=True), trace4(), "batcher guard only")
        print11(base)
        print11(guard)
        cost = guard["step_ms_median"] - base["step_ms_median"]
        parts = guard_parts(torch, dev, (8, cfg.vocab))
        out["guard_ms_per_step"], out["guard_parts_ms"] = cost, parts
        print(f"      the non-finite guard (a {8 * cfg.vocab * 4 / 1e6:.2f} MB device-to-host "
              f"copy of the last logits a step): {cost:+.2f} ms on the median step; alone, "
              f"the copy {parts['copy_ms']:.3f} ms, the host isfinite {parts['isfinite_ms']:.3f}"
              f" ms (medians of 20 calls)")
        hold11(torch, model, params, base, guard, strict=True)
        chaos = ChaosInjector(ChaosConfig(seed=0, **batcher_faults(0.1, paged=True, abft=True)))
        hurt = serve11(torch, batcher(chaos=chaos, abft=True), trace4(), "batcher chaos + abft")
        print11(hurt)
        hold11(torch, model, params, base, hurt, strict=True)
        _check11("11d", hurt, abft=True)
        h, failed = hurt["health"], sorted(r for r, x in hurt["reasons"].items() if x == "failed")
        flips = hurt["chaos"]["bitflips_injected"]
        print(f"      bit flips injected {flips}, SDC detected {h['abft']['sdc_detected']}, "
              f"corrected {h['abft']['sdc_corrected']}; quarantined {failed}, poisoned "
              f"{hurt['poisoned']} ({hurt['chaos']['poisons_injected']} poisons)")
        if not (0 < flips == h["abft"]["sdc_detected"] == h["abft"]["sdc_corrected"]) \
                or hurt["abft_stats"]["tiles_flagged"] \
                or failed != hurt["poisoned"] or len(failed) != hurt["chaos"]["poisons_injected"]:
            raise AssertionError(f"11d: flips {flips}, abft {h['abft']}, "
                                 f"{hurt['abft_stats']}, failed {failed}, poisoned "
                                 f"{hurt['poisoned']}")
        out["11d"], out["11d_ref"], out["11d_guard"] = hurt, base, guard

        print("[11e] k = 4 n-gram speculation under the same chaos, abft=True")
        spec = dict(speculate=4, drafter=NGramDrafter())
        base = serve11(torch, batcher(new=16, **spec), trace4(8, 16), "spec4 fault-free")
        print11(base)
        spec["drafter"] = NGramDrafter()
        chaos = ChaosInjector(ChaosConfig(seed=0, **batcher_faults(0.1, paged=True, abft=True)))
        hurt = serve11(torch, batcher(new=16, chaos=chaos, abft=True, **spec), trace4(8, 16),
                       "spec4 chaos + abft")
        print11(hurt)
        hold11(torch, model, params, base, hurt, strict=True)
        _check11("11e", hurt, decode=False, verify=True, abft=True)
        h, failed = hurt["health"], sorted(r for r, x in hurt["reasons"].items() if x == "failed")
        if not (hurt["chaos"]["bitflips_injected"] == h["abft"]["sdc_detected"]
                == h["abft"]["sdc_corrected"]) or failed != hurt["poisoned"]:
            raise AssertionError(f"11e: {h}, failed {failed}, poisoned {hurt['poisoned']}")
        out["11e"], out["11e_ref"] = hurt, base
    out["seconds"] = time.perf_counter() - t_phase
    print(f"    phase 11: {out['seconds']:.1f} s")
    after = then(model, params, cfg) if then is not None else None
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return out, after


# ---------------------------------------------------------------------------
# phase 12: tensor parallelism on one card, the ring collective GEMMs
# ---------------------------------------------------------------------------

RING_P = 8  # LocalRing(8): every rank of the model-axis ring on the one card
DIRS = ("fwd", "bwd", "bidir")
# 12a: (label, mode, M, K, N, dtype or named policy, epilogue, directions) at
# llama3.2-1b's projections: q / k / v (k and v share a shape) and up+gate
# on the all-gather ring, out and down (with the residual fused) on the
# reduce-scatter ring; M = 64 a prefill chunk (m_loc = 8), M = 8 a decode
# step at 8 slots (m_loc = 1: bidir runs "fwd")
RING_SHAPES = (
    *[(f"{w} M={M}", "allgather", M, 2048, N, "float32", {}, DIRS)
      for w, N in (("q", 2048), ("k / v", 512)) for M in (64, 8)],
    ("up+gate swiglu M=64", "allgather", 64, 2048, 8192, "float32",
     dict(activation="swiglu"), ("bidir",)),
    *[(f"{w} M={M}", "reduce_scatter", M, K, 2048, "float32", dict(residual=True), DIRS)
      for w, K in (("out", 2048), ("down", 8192)) for M in (64, 8)],
    ("q M=64 bf16", "allgather", 64, 2048, 2048, "bfloat16", {}, ("bidir",)),
    ("down M=64 bf16", "reduce_scatter", 64, 8192, 2048, "bfloat16", dict(residual=True),
     ("bidir",)),
    ("q M=64 int8", "allgather", 64, 2048, 2048, "int8", {}, ("bidir",)),
    ("q M=64 int8_all (a_scale sidecar)", "allgather", 64, 2048, 2048, "int8_all", {},
     ("bidir",)),
)
# the kernels line's two rows: a decode step's q (all-gather) and down
# (reduce-scatter) projections, the rings 12c (ii) runs most
RING_ROWS = {"allgather": ("q M=8", "fwd"), "reduce_scatter": ("down M=8", "fwd")}


def _ring_operands(torch, dev, M, K, N, dt, ep_kw, seed):
    """Whole operands of one GEMM: f32 / bf16, or the payloads and scales of
    a named policy (f32 output)."""
    from repro_torch.core.precision import NAMED_POLICIES
    from repro_torch.kernels.quant import quantize_operand

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev)
    w = torch.randn((K, N), generator=g, device=dev) / math.sqrt(K)
    wg = (torch.randn((K, N), generator=g, device=dev) / math.sqrt(K)
          if ep_kw.get("activation") == "swiglu" else None)
    res = torch.randn((M, N), generator=g, device=dev) if ep_kw.get("residual") else None
    op = dict(w_gate=wg, residual=res, a_scale=None, b_scale=None, bg_scale=None)
    if dt in REL_TOL:
        t = getattr(torch, dt)
        op.update(x=x.to(t), w=w.to(t), out_dtype=t,
                  w_gate=None if wg is None else wg.to(t), residual=None if res is None
                  else res.to(t))
        return op
    pol = NAMED_POLICIES[dt]
    qa, a_s = quantize_operand(x, pol.a, "a")
    qb, b_s = quantize_operand(w, pol.b, "b")
    op.update(x=qa.contiguous(), w=qb, a_scale=a_s, b_scale=b_s, out_dtype=torch.float32)
    return op


def _ring_shards(op, mode, P):
    """The per-rank arguments of the ring bodies: the all-gather ring's x
    rows (and their scales) and contiguous weight / residual / scale
    columns; the reduce-scatter ring's x and weight K-slices, residual rows
    and whole scales."""
    x, w = op["x"], op["w"]
    (M, K), N = x.shape, w.shape[1]
    if mode == "allgather":
        m, n = M // P, N // P

        def cols(t):
            return None if t is None else [t[..., r * n:(r + 1) * n].contiguous()
                                           for r in range(P)]
        return ([x[r * m:(r + 1) * m] for r in range(P)], cols(w), dict(
            b_gate=cols(op["w_gate"]), residual=cols(op["residual"]),
            a_scale=None if op["a_scale"] is None else
            [op["a_scale"][r * m:(r + 1) * m] for r in range(P)],
            b_scale=cols(op["b_scale"]), bg_scale=cols(op["bg_scale"])))
    k, m = K // P, M // P
    return ([x[:, r * k:(r + 1) * k].contiguous() for r in range(P)],
            [w[r * k:(r + 1) * k] for r in range(P)], dict(
                residual=None if op["residual"] is None else
                [op["residual"][r * m:(r + 1) * m] for r in range(P)],
                a_scale=None if op["a_scale"] is None else [op["a_scale"]] * P,
                b_scale=None if op["b_scale"] is None else [op["b_scale"]] * P))


def _whole_kw(op, ep_kw):
    """Kernel 1's arguments for the whole GEMM."""
    from repro_torch.kernels import mx_matmul as mm

    ep = mm.Epilogue(**ep_kw, a_scale=op["a_scale"] is not None,
                     b_scale=op["b_scale"] is not None)
    return dict(epilogue=ep, b_gate=op["w_gate"], residual=op["residual"],
                a_scale=op["a_scale"], b_scale=op["b_scale"], bg_scale=op["bg_scale"],
                out_dtype=op["out_dtype"])


def _chunk_rows(direction, i, step, m, P):
    """The x rows rank i multiplies at `step` of an all-gather ring."""
    if direction == "bidir" and m % 2 == 0:
        f, b = (i - step) % P, (i + step) % P
        return [*range(f * m, f * m + m // 2), *range(b * m + m // 2, (b + 1) * m)]
    src = ((i + step) if direction == "bwd" else (i - step)) % P
    return list(range(src * m, (src + 1) * m))


def check_ring(torch, dev, ring, label, mode, M, K, N, dt, ep_kw, direction, seed):
    """One ring GEMM over `ring` (chunk GEMMs on kernel 1) against its
    serialized reference and one kernel-1 launch on the whole GEMM (f32 and
    quantized within 1e-4 * max|ref|, bf16 2e-2); on the all-gather ring
    each step's output rows bitwise kernel 1 on the same rows and shard.
    Times: the ring (`_ring_ms`: median of 7 windows of one call), the
    serialized reference, kernel 1 on the whole GEMM, the library call on
    the whole GEMM (median of 3 windows of 10 calls); the whole GEMM's
    bound; the bytes the ring's hops copy."""
    from repro_torch.kernels import mx_collective_matmul as cm
    from repro_torch.kernels import mx_matmul as mm

    P = ring.size
    ring_fn = cm.ring_allgather_matmul if mode == "allgather" else cm.ring_matmul_reduce_scatter
    ser_fn = (cm.serialized_allgather_matmul if mode == "allgather"
              else cm.serialized_matmul_psum)
    cc, ep, dim = cm.ChunkCompute("cuda_mx"), mm.Epilogue(**ep_kw), int(mode == "allgather")
    tol_dt = dt if dt in REL_TOL else "float32"

    def make(s):
        op = _ring_operands(torch, dev, M, K, N, dt, ep_kw, s)
        return op, *_ring_shards(op, mode, P)

    op, xs, ws, kw = make(seed)
    el_a, el_b = op["x"].element_size(), op["w"].element_size()
    nmat = 2 if op["w_gate"] is not None else 1
    el_out = torch.empty((), dtype=op["out_dtype"]).element_size()
    nbytes = (el_a * M * K + nmat * el_b * K * N + el_out * M * N
              + (el_out * M * N if ep_kw.get("residual") else 0)
              + (4 * M if op["a_scale"] is not None else 0)
              + (4 * nmat * N if op["b_scale"] is not None else 0))
    sets = [(op, xs, ws, kw)] + [make(seed + 1 + c) for c in range(_copies(nbytes) - 1)]

    def run_ring(op_, xs_, ws_, kw_):
        return ring_fn(ring, xs_, ws_, compute=cc, epilogue=ep, direction=direction,
                       out_dtype=op_["out_dtype"], **kw_)

    def run_ser(op_, xs_, ws_, kw_):
        return ser_fn(ring, xs_, ws_, compute=cc, epilogue=ep, out_dtype=op_["out_dtype"],
                      **kw_)

    def run_whole(op_, *_):
        return mm.mx_matmul_fused(op_["x"], op_["w"], **_whole_kw(op_, ep_kw))

    moved0 = ring.bytes_moved
    outs = run_ring(op, xs, ws, kw)
    ring_bytes = ring.bytes_moved - moved0
    got = torch.cat(outs, dim)
    ser = torch.cat(run_ser(op, xs, ws, kw), dim)
    whole = run_whole(op)
    err, tol = _err(torch, got, ser, tol_dt)
    err_whole, tol_whole = _err(torch, got, whole, tol_dt)
    bitwise = None
    if mode == "allgather":
        m = M // P
        bitwise = True
        for i in range(P):
            for step in range(P):
                rows = torch.tensor(_chunk_rows(direction, i, step, m, P), device=dev)
                kw1 = _whole_kw(op, ep_kw)
                kw1.update(b_gate=_at(kw["b_gate"], i), bg_scale=_at(kw["bg_scale"], i),
                           b_scale=_at(kw["b_scale"], i),
                           residual=None if kw["residual"] is None
                           else kw["residual"][i][rows].contiguous(),
                           a_scale=None if op["a_scale"] is None else op["a_scale"][rows])
                want = mm.mx_matmul_fused(op["x"][rows].contiguous(), ws[i], **kw1)
                bitwise &= torch.equal(outs[i][rows], want)
    fns = dict(plain_ms=(run_ser, sets), kernel_ms=(run_whole, sets))
    library = None
    if dt in REL_TOL and not ep_kw:
        library = "torch.matmul"
        fns["library_ms"] = (lambda op_, *_: torch.matmul(op_["x"], op_["w"]), sets)
    elif dt in REL_TOL and set(ep_kw) == {"residual"}:
        library = "torch.addmm"
        fns["library_ms"] = (lambda op_, *_: torch.addmm(op_["residual"], op_["x"], op_["w"]),
                             sets)
    t = _time_ms(torch, fns, windows=3, iters=10, warmup=1)
    t["kernel_ms"] = statistics.median(t["windows_ms"]["kernel_ms"])
    cycle = itertools.cycle(sets)
    t["ms"], t["windows_ms"]["ms"] = _ring_ms(torch, lambda: run_ring(*next(cycle)))
    bound, by = _bound_ms(nbytes, 2 * M * N * K * nmat, _peak_type(op["x"], op["w"]))
    out = dict(label=label, mode=mode, direction=direction, M=M, K=K, N=N, dtype=dt,
               epilogue=ep_kw, max_abs_err=err, tol=tol, err_whole=err_whole,
               tol_whole=tol_whole, chunk_bitwise=bitwise, ring_bytes=ring_bytes, **t,
               library=library, bound_ms=bound, bound_by=by)
    print(f"    [12a] {mode} {label} {direction} {dt}: ring {t['ms']:.4f} ms / serialized "
          f"{t['plain_ms']:.4f} / kernel 1 whole {t['kernel_ms']:.4f} / "
          f"{library or 'no library call'} "
          f"{t['library_ms'] if t['library_ms'] is None else round(t['library_ms'], 4)} / "
          f"bound {bound:.4f} ({by}); hops copy {ring_bytes / 1e6:.3f} MB; err "
          f"{err:.3g} (tol {tol:.3g}) vs serialized, {err_whole:.3g} vs whole"
          + ("" if bitwise is None else f"; chunk rows bitwise kernel 1: {bitwise}"))
    if not (err <= tol and err_whole <= tol_whole and bitwise is not False):
        raise AssertionError(f"12a {mode} {label} {direction}: {out}")
    return out


def _at(values, i):
    return None if values is None else values[i]


def _ring_ms(torch, call, windows=7, spin_s=0.05):
    """A ring call's device time: the median of `windows` windows of one
    call, each behind a spin kernel of `spin_s` seconds, the garbage
    collector held off.  A ring call enqueues 130-350 kernels and copies,
    and its host time is several times its device time
    (tools/ring_timing.py): a window of several calls outruns the launch
    queue that `_time_ms`'s spin keeps ahead of the host, and a host pause
    longer than the spin times the host.
    Returns (median ms, every window's ms)."""
    call()
    torch.cuda.synchronize()
    per = []
    gc.disable()
    try:
        for _ in range(windows):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
            start.record()
            call()
            end.record()
            end.synchronize()
            per.append(start.elapsed_time(end))
    finally:
        gc.enable()
    return statistics.median(per), per


def phase12(torch, dev, model, params, cfg, phase4_step_ms):
    """Phase 12: llama3.2-1b at full width (f32, the weights of phase 11),
    tensor parallelism on one card: the ring GEMMs over LocalRing(8), their
    chunk GEMMs on kernel 1 ("cuda_mx"), against the serialized references,
    kernel 1 on the whole GEMM and the library call (12a); ABFT on the ring
    (12b); the prefill step and the paged batcher under collective_policy
    against the same runs without it (12c); the MoE's collective branch
    and GPipe (12d)."""
    from repro_torch.configs import get_config
    from repro_torch.core import ops
    from repro_torch.kernels import abft as abft_mod
    from repro_torch.kernels import mx_collective_matmul as cm
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import make_trace
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.modules import layer_slice
    from repro_torch.models.moe import MoE
    from repro_torch.models.transformer import make_block
    from repro_torch.parallel.pipeline import gpipe_apply
    from repro_torch.parallel.sharding import collective_policy
    from repro_torch.runtime.batcher import ContinuousBatcher

    t_phase = time.perf_counter()
    out = {}
    mesh = make_mesh((1, RING_P), ("data", "model"))
    ring = mesh.ring("model")
    print(f"[12a] the ring GEMMs at llama3.2-1b's shapes over LocalRing({RING_P}) on one card: "
          "every chunk GEMM kernel 1; the multi-GPU ring (NCCL) is not measured here")
    with torch.no_grad():
        out["12a"] = [check_ring(torch, dev, ring, label, mode, M, K, N, dt, ep_kw, d,
                                 1200 + 10 * n)
                      for n, (label, mode, M, K, N, dt, ep_kw, dirs) in enumerate(RING_SHAPES)
                      for d in dirs]
        print(f"    12a: {time.perf_counter() - t_phase:.1f} s")

        print("[12b] ABFT on the ring: one ring fault per mode, flagged and recovered")
        out["12b"] = {}
        for mode, (M, K, N, ep_kw) in (("allgather", (64, 2048, 2048, {})),
                                       ("reduce_scatter", (64, 8192, 2048,
                                                           dict(residual=True)))):
            op = _ring_operands(torch, dev, M, K, N, "float32", ep_kw, 1300)
            with ops.use_policy(ops.MXPolicy("cuda_mx")), collective_policy(mesh):
                cm.reset_ring_stats()
                clean = ops.linear(op["x"], op["w"], residual=op["residual"], tp_mode=mode,
                                   abft=True)
                reads_clean = cm.ring_stats()["flag_reads"]
                abft_mod.reset_abft_stats()
                fault = abft_mod.AbftConfig(fault=abft_mod.TileFault(3, 0, 1, 2, 5.0))
                got = ops.linear(op["x"], op["w"], residual=op["residual"], tp_mode=mode,
                                 abft=fault)
                stats, s = abft_mod.abft_stats(), cm.ring_stats()
                off = ops.linear(op["x"], op["w"], residual=op["residual"], tp_mode=mode,
                                 abft=False)
            r = dict(stats=stats, bitwise_fault_free=torch.equal(got, clean),
                     flag_reads_clean=reads_clean,
                     flag_reads_faulted=s["flag_reads"] - reads_clean,
                     err_abft_off=_err(torch, got, off, "float32"))
            print(f"    [12b] {mode}: {stats}; recovery bitwise the fault-free ring "
                  f"{r['bitwise_fault_free']}; host reads of the flag total: "
                  f"{reads_clean} for the clean ring linear, {r['flag_reads_faulted']} for "
                  f"the faulted one (its rerun included); against ABFT off "
                  f"{r['err_abft_off'][0]:.3g} (tol {r['err_abft_off'][1]:.3g})")
            if not (r["bitwise_fault_free"] and reads_clean == 1
                    and r["flag_reads_faulted"] == 2
                    and stats == dict(gemms_verified=1, tiles_flagged=1, tiles_recovered=1,
                                      sdc_errors=0)
                    and r["err_abft_off"][0] <= r["err_abft_off"][1]):
                raise AssertionError(f"12b {mode}: {r}")
            out["12b"][mode] = r

        print("[12c] (i) the prefill step (2 x 256 tokens) under collective_policy against "
              "the same step without it")
        step = make_prefill_step(model, cfg)
        g = torch.Generator(device=dev).manual_seed(1400)
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 256), generator=g, device=dev)}
        with ops.use_policy(ops.MXPolicy("cuda_mx")):
            ref = step(params, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = step(params, batch)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            ops.clear_shard_cache()
            with collective_policy(mesh):
                got = step(params, batch)  # builds the weight shards
                cm.reset_ring_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = step(params, batch)
                torch.cuda.synchronize()
                ring_ms = 1e3 * (time.perf_counter() - t0)
                s = cm.ring_stats()
        err, tol = _err(torch, got, ref, "float32")
        tol = 10 * tol  # 1e-3 * max|ref|, phase 5's tolerance on logits
        shard_gb = ops.shard_cache_bytes() / 1e9
        out["12c_forward"] = dict(max_abs_err=err, tol=tol, ms=ring_ms, plain_ms=plain_ms,
                                  ring=s, shard_cache_gb=shard_gb)
        print(f"    logits err {err:.4g} (tol {tol:.4g}); {ring_ms:.1f} ms under the ring, "
              f"{plain_ms:.1f} ms without (one host-timed call each); ring linears {s}; the "
              f"kept weight shards {shard_gb:.3f} GB (the all-gather projections' weights)")
        if not (err <= tol and s["allgather"] == 4 * cfg.n_layers
                and s["reduce_scatter"] == 2 * cfg.n_layers and not s["fallbacks"]):
            raise AssertionError(f"12c (i): {out['12c_forward']}")
        del ref, got

        print("[12c] (ii) the paged batcher on phase 4's trace cut to 8 requests x 8 new "
              "tokens, under collective_policy and without it")
        prompt_len, gen, ps = 128, 8, 16

        def batcher():
            ml = prompt_len + gen
            return ContinuousBatcher(model, params, batch_slots=8, max_len=ml, page_size=ps,
                                     num_pages=10 * -(-ml // ps), prefix_cache=True,
                                     prefill_chunk=64)

        with ops.use_policy(ops.MXPolicy("cuda_mx")):
            plain = serve11(torch, batcher(), make_trace(cfg, 8, prompt_len, gen,
                                                         prefix_cache=True), "no policy")
            with collective_policy(mesh):
                b, reqs = batcher(), make_trace(cfg, 8, prompt_len, gen, prefix_cache=True)
                cm.reset_ring_stats()
                moved0 = ring.bytes_moved
                run = serve11(torch, b, reqs, "collective_policy, LocalRing(8)")
                run["ring"], run["ring_bytes"] = cm.ring_stats(), ring.bytes_moved - moved0
        print11(plain)
        print11(run)
        s = run["ring"]
        print(f"      ring chunk GEMMs on kernel 1: all-gather {s['allgather_chunks']} "
              f"({s['allgather']} ring linears), reduce-scatter {s['reduce_scatter_chunks']} "
              f"({s['reduce_scatter']}); fallbacks {s['fallbacks']} "
              f"{s['fallback_reasons']}; mx_matmul_fused launches "
              f"{run['launches']['mx_matmul_fused']}, mx_flash_decode "
              f"{run['launches']['mx_flash_decode']}; the hops copied "
              f"{run['ring_bytes'] / 1e9:.3f} GB; median step "
              f"{run['step_ms_median']:.2f} ms against {plain['step_ms_median']:.2f} ms "
              f"without the policy and phase 4's {phase4_step_ms:.2f} ms")
        hold11(torch, model, params, plain, run, strict=False)
        if not (s["allgather_chunks"] and s["reduce_scatter_chunks"]
                and run["launches"]["mx_flash_decode"]
                and s["allgather_chunks"] + s["reduce_scatter_chunks"]
                <= run["launches"]["mx_matmul_fused"]):
            raise AssertionError(f"12c (ii): a ring mode did not launch: {s}, "
                                 f"{run['launches']}")
        out["12c_serve"], out["12c_serve_ref"] = run, plain
        ops.clear_shard_cache()

        print("[12d] the MoE's collective branch at grok-1-smoke's widths, and GPipe over "
              "4 stages of one full-width llama layer")
        scfg = get_config("grok-1-314b-smoke")
        moe = MoE(scfg.d_model, scfg.d_ff, scfg.n_experts, scfg.top_k)
        mp = moe.init(1500, device=dev)
        x = torch.randn((2, 64, scfg.d_model), generator=g, device=dev)
        with ops.use_policy(ops.MXPolicy("cuda_mx")):
            ref, aux = moe(mp, x)
            cm.reset_ring_stats()
            with collective_policy(mesh):
                got, aux2 = moe(mp, x)
            s = cm.ring_stats()
        err, tol = _err(torch, got, ref, "float32")
        out["12d_moe"] = dict(max_abs_err=err, tol=tol, ring=s, aux=(float(aux), float(aux2)))
        print(f"    MoE (d_model {scfg.d_model}, d_ff {scfg.d_ff}, {scfg.n_experts} experts, "
              f"top-{scfg.top_k}): err {err:.3g} (tol {tol:.3g}) against the grouped launch; "
              f"aux {float(aux2):.6g} / {float(aux):.6g}; ring {s}")
        if not (err <= tol and s["allgather_chunks"] and s["reduce_scatter_chunks"]):
            raise AssertionError(f"12d MoE: {out['12d_moe']}")
        block = make_block("dense", cfg)
        stages = _slice_tree(params["seg0"], 4)
        xs = torch.randn((4, 1, 64, cfg.d_model), generator=g, device=dev)
        with ops.use_policy(ops.MXPolicy("cuda_mx")):
            got = gpipe_apply(lambda p, h: block(p, h)[0], stages, xs,
                              mesh=make_mesh((4,), ("pod",)))
            want = xs
            for j in range(4):
                want = torch.stack([block(layer_slice(params["seg0"], j), h)[0] for h in want])
        err, tol = _err(torch, got, want, "float32")
        out["12d_gpipe"] = dict(max_abs_err=err, tol=tol)
        print(f"    GPipe, 4 stages x 4 microbatches of 1 x 64 tokens: err {err:.3g} "
              f"(tol {tol:.3g}) against the layers in sequence")
        if not err <= tol:
            raise AssertionError(f"12d GPipe: {out['12d_gpipe']}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"    phase 12: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: training
# ---------------------------------------------------------------------------

# one train step held against another (13b: the card against the CPU): the
# worst leaf's m within this * max|ref| (v twice it), 1e-5 for the others.
# The SSM and xLSTM recurrences amplify f32 rounding: on the CPU, at smoke
# size, the step-1 gradients of JAX and of the port stand 7.3e-6 and 6.5e-6
# (zamba2) and 2.2e-5 and 4.1e-5 (xlstm) * max from the f64 gradient
TRAIN_STEP_TOL = {"zamba2-2.7b": 5e-5, "xlstm-125m": 1e-4}
# microbatch 2 against 1 at full width: the halves' gradients summed in f32
# (the embedding's backward adds rows with atomics, in no fixed order)
MICROBATCH_TOL = 5e-5

# training's pieces at smoke size in a process of their own on the card,
# deterministic (the embedding's backward sums with atomics otherwise):
# a TrainLoop with a failure at step 6 of 10 against an uninterrupted run,
# a non-finite loss, and the last checkpoint restored onto the CPU
LOOP_CHILD = r"""
import json, sys, tempfile
from pathlib import Path
import torch
torch.use_deterministic_algorithms(True)
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import tree as T
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import launch_counts
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.fault import FaultInjector, NanLossError, TrainLoop

dev = torch.device("cuda")
cfg = get_config("llama3.2-1b-smoke")
model = build_model(cfg)
opt = AdamW(lr=1e-3)
step = make_train_step(model, cfg, opt, inplace=True)
tmp = Path(tempfile.mkdtemp())
runs = {}
for name, fail in (("plain", ()), ("failed", (6,))):
    params = model.init(0, device=dev)
    loop = TrainLoop(train_step=step, ckpt=CheckpointManager(tmp / name), checkpoint_every=4,
                     fault_injector=FaultInjector(fail_at_steps=fail))
    runs[name] = loop.run(params, opt.init(params), SyntheticLM(cfg, seq_len=32,
                                                                 global_batch=4),
                          total_steps=10)
(p0, o0, h0), (p1, o1, h1) = runs["plain"], runs["failed"]
leaves0, leaves1 = T.leaves((p0, o0)), T.leaves((p1, o1))
nan = False
try:
    TrainLoop(train_step=lambda p, o, b: (p, o, {"loss": torch.tensor(float("nan"), device=dev)}),
              ckpt=CheckpointManager(tmp / "nan")).run(p0, o0, SyntheticLM(cfg, 32, 4), 3)
except NanLossError:
    nan = True
ck = CheckpointManager(tmp / "failed")
state = ck.restore({"params": p1, "opt": o1, "step": 0}, device=torch.device("cpu"))
cpu = T.leaves((state["params"], state["opt"]))
json.dump(dict(
    restarts=[h0["restarts"], h1["restarts"]], steps_run=[h0["steps_run"], h1["steps_run"]],
    leaves=len(leaves0), on_cuda=all(t.is_cuda for t in leaves0 + leaves1),
    bitwise=all(torch.equal(a, b) for a, b in zip(leaves0, leaves1)),
    nan_raised=nan, restored_step=int(state["step"]), latest=ck.latest_step(),
    cpu_bits=all(c.device.type == "cpu" and torch.equal(c, g.cpu())
                 for c, g in zip(cpu, leaves1)),
    launches=launch_counts()), open(sys.argv[1], "w"))
"""


def _leaf_paths(tree, prefix=""):
    """The "/"-joined key path of each leaf of a nested dict, in JAX's leaf
    order (`core/tree.py`)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def _hold_step(torch, ref, got, tol, lr, weight_decay, eps=1e-8, b1=0.9):
    """One train step against another from the same parameters and zero
    moments (the CPU tests' `hold_step`): the worst ratios of the metrics
    (relative), m and v (to max|ref| per leaf) and the parameters where the
    step's gradient is at least 1e3 * eps (to max|ref|); elsewhere the first
    Adam step's g / (|g| + eps) turns rounding noise into an update of up to
    lr, and the parameters are held to 2 * lr * (1 + weight_decay * |p|).
    Returns (record, ok)."""
    from repro_torch.core import tree as T

    (rp, rs, rm), (gp, gs, gm) = ref, got
    rec = {k: abs(float(gm[k]) - float(rm[k])) / max(abs(float(rm[k])), 1e-30)
           for k in ("loss", "grad_norm", "lr")}
    worst = dict(m=0.0, v=0.0, params=0.0, loose=0, loose_bounded=True, m_leaf=None)
    paths = _leaf_paths(rp)
    for path, p, m, v, p0, m0, v0 in zip(paths, *(T.leaves(t) for t in (gp, gs.m, gs.v, rp,
                                                                         rs.m, rs.v))):
        dv = p.device  # the step's device (the other may be the CPU's)
        p, m, v, p0, m0, v0 = (t.detach().float().to(dv) for t in (p, m, v, p0, m0, v0))
        for a, b, k in ((m, m0, "m"), (v, v0, "v")):
            r = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
            if k == "m" and r > worst["m"]:
                worst["m_leaf"] = path
            worst[k] = max(worst[k], r)
        sharp = (m0 / (1 - b1)).abs() >= 1e3 * eps
        d = (p - p0).abs()
        if sharp.any():
            worst["params"] = max(worst["params"],
                                  d[sharp].max().item() / max(p0.abs().max().item(), 1e-30))
        worst["loose"] += int((~sharp).sum())
        worst["loose_bounded"] &= bool((d <= 2 * lr * (1 + weight_decay * p0.abs())).all())
    rec.update(worst)
    ok = (max(rec["loss"], rec["grad_norm"], rec["lr"], rec["m"], rec["params"]) <= tol
          and rec["v"] <= 2 * tol and rec["loose_bounded"])
    return rec, ok


def phase13(torch, dev):
    """Phase 13, training (the plain path under autograd, "torch" backend,
    as JAX trains on "xla"): 13a the kernels' refusal under grad; 13b one
    train step of every smoke config on the card against the CPU; 13c
    llama3.2-1b at full width (the f32 gradient against f64, 8 steps on one
    batch, microbatch 2 against 1, the step against its bound, tokens/s,
    peak memory); 13d the fault-tolerant loop at smoke size in a
    deterministic process (LOOP_CHILD); 13e the launcher with a failure;
    GPipe's gradient over LocalRing(4) on the card."""
    import tempfile

    from repro_torch import kernels
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.core import ops
    from repro_torch.core import tree as T
    from repro_torch.core.roofline import train_step_bound_s
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.mx_flash_attention import mx_flash_attention
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.modules import param_count
    from repro_torch.models.transformer import make_block
    from repro_torch.optim.adamw import AdamW, global_norm
    from repro_torch.optim.schedules import constant
    from repro_torch.parallel.pipeline import gpipe_apply
    from tools.accumulation_witness import plain_f64, widened

    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()  # what earlier phases hold (zamba2's weights)
    out = {}
    failed = []  # every sub-phase runs and prints; the phase fails at its end
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    # 13d and 13e run in processes of their own, beside 13a, 13b and the
    # f64 witness; they end before 13c's steps are timed
    child = subprocess.Popen([sys.executable, "-c", LOOP_CHILD, str(tmp / "loop.json")],
                             cwd=ROOT, env=dict(env, CUBLAS_WORKSPACE_CONFIG=":4096:8"),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    launch_args = ["--arch", "llama3.2-1b", "--smoke", "--steps", "20", "--inject-failure",
                   "7", "--ckpt-dir", str(tmp / "launcher")]
    t_launch = time.perf_counter()
    launch = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *launch_args],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)

    print("[13a] the kernels refuse an operand that requires grad; under no_grad the bits "
          "of phase 3's calls")
    g = torch.Generator(device=dev).manual_seed(1300)
    x = torch.randn((8, 8192), generator=g, device=dev)
    w = torch.randn((8192, 2048), generator=g, device=dev) / 8192 ** 0.5
    res = torch.randn((8, 2048), generator=g, device=dev)
    q, k, v = (torch.randn((4, 256, h, 64), generator=g, device=dev) for h in (32, 8, 8))
    mx = ops.MXPolicy("cuda_mx")
    calls = {
        "linear (cuda_mx, M=8 K=8192 N=2048 +residual)":
            lambda wt: ops.linear(x, wt, residual=res, policy=mx),
        "mx_flash_attention (B=4 L=256 H=32/8 d=64)":
            lambda qt: mx_flash_attention(qt, k, v, causal=True),
    }
    guard = {}
    for (name, call), operand in zip(calls.items(), (w, q)):
        plain = call(operand)
        before = kernels.launch_counts()
        try:
            call(operand.clone().requires_grad_())
            refused = False
        except RuntimeError as e:
            refused = "requires grad" in str(e)
        moved = kernels.launch_counts() != before
        with torch.no_grad():
            again = call(operand.clone().requires_grad_())
        torch.cuda.synchronize()
        guard[name] = dict(refused=refused, launched_when_refused=moved,
                           no_grad_bitwise=torch.equal(again, plain))
        print(f"    {name}: refused {refused}, launched {moved}; under no_grad bitwise "
              f"{guard[name]['no_grad_bitwise']}")
        if not refused or moved or not guard[name]["no_grad_bitwise"]:
            failed.append(f"13a {name}: {guard[name]}")
    out["13a"] = guard

    print("[13b] one train step of every smoke config on the card against the CPU "
          "(AdamW lr 1e-3; the kernels' launch counters must not move)")
    fams = {}
    kernels.reset_launch_counts()
    for arch in ARCH_IDS:
        cfg = get_config(arch + "-smoke")
        model = build_model(cfg)
        opt = AdamW(lr=1e-3)
        batch = SyntheticLM(cfg, seq_len=32, global_batch=2).next_batch()
        p_cpu = model.init(0, device="cpu")
        p_dev = T.map(lambda t: t.to(dev), p_cpu)
        step = steps.make_train_step(model, cfg, opt)
        ref = step(p_cpu, opt.init(p_cpu), batch)
        got = step(p_dev, opt.init(p_dev), batch)
        on_cuda = all(t.is_cuda for t in T.leaves(got[:2]))
        tol = TRAIN_STEP_TOL.get(arch, 1e-5)
        rec, ok = _hold_step(torch, ref, got, tol, 1e-3, 0.1)
        rec.update(on_cuda=on_cuda, tol=tol, loss_value=float(got[2]["loss"]))
        fams[arch] = rec
        print(f"    {arch}: loss {float(got[2]['loss']):.6f} / cpu {float(ref[2]['loss']):.6f};"
              f" worst rel: loss {rec['loss']:.2e} grad_norm {rec['grad_norm']:.2e} m "
              f"{rec['m']:.2e} ({rec['m_leaf']}) v {rec['v']:.2e} params {rec['params']:.2e} "
              f"({rec['loose']} near-eps elements bounded {rec['loose_bounded']}); tol {tol:g};"
              f" on cuda {on_cuda}")
        if not (ok and on_cuda):
            failed.append(f"13b {arch}: {rec}")
    out["13b"] = fams
    out["13b_launches"] = kernels.launch_counts()
    if any(out["13b_launches"].values()):
        failed.append(f"13b launched a kernel: {out['13b_launches']}")

    print("[13d/13e run beside] GPipe's gradient over LocalRing(4) on the card (the hops "
          "copy on a side stream) against the stages in sequence")
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    n_params = param_count(params)
    print(f"    llama3.2-1b: init {time.perf_counter() - t0:.1f} s, {n_params / 1e9:.4f} B "
          f"params")
    block = make_block("dense", cfg)
    xs = torch.randn((4, 1, 64, cfg.d_model), generator=g, device=dev)
    ct = torch.randn((4, 1, 64, cfg.d_model), generator=g, device=dev)
    stages0 = _slice_tree(params["seg0"], 4)
    with ops.use_policy(ops.MXPolicy("torch")):
        st = T.map(lambda t: t.detach().clone().requires_grad_(), stages0)
        xg = xs.clone().requires_grad_()
        got = gpipe_apply(lambda p, h: block(p, h)[0], st, xg, mesh=make_mesh((4,), ("pod",)))
        gg = torch.autograd.grad((got * ct).sum(), [xg, *T.leaves(st)])
        sq = T.map(lambda t: t.detach().clone().requires_grad_(), stages0)
        xq = xs.clone().requires_grad_()
        want = xq
        for j in range(4):
            want = torch.stack([block(T.map(lambda t, j=j: t[j], sq), h)[0] for h in want])
        gw = torch.autograd.grad((want * ct).sum(), [xq, *T.leaves(sq)])
    gerr = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
               for a, b in zip(gg, gw))
    out["13_gpipe"] = dict(worst_rel=gerr, leaves=len(gw), forward_bitwise=torch.equal(got, want))
    print(f"    GPipe, 4 full-width llama layers x 4 microbatches of 1 x 64 tokens: gradient "
          f"worst {gerr:.3g} * max|ref| over {len(gw)} leaves (tol 1e-5); forward bitwise "
          f"{out['13_gpipe']['forward_bitwise']}")
    if not gerr <= 1e-5:
        failed.append(f"13 GPipe: {out['13_gpipe']}")
    del st, xg, got, gg, sq, xq, want, gw

    print("[13c] llama3.2-1b at full width (16 layers, d_model 2048, vocab 128256, tied, f32, "
          "seed 0), SyntheticLM seed 0, batch 8 x 128")
    batch = steps.batch_to(SyntheticLM(cfg, seq_len=128, global_batch=8, seed=0).next_batch(),
                           dev)
    T_tok = batch["tokens"].numel()
    t0 = time.perf_counter()
    _, m32, g32 = steps.value_and_grad(model, cfg, params, batch)
    torch.cuda.synchronize()
    t32 = time.perf_counter() - t0
    n32 = float(global_norm(g32))
    t0 = time.perf_counter()
    with plain_f64(torch):
        _, m64, g64 = steps.value_and_grad(model, cfg, widened(params), batch)
    torch.cuda.synchronize()
    t64 = time.perf_counter() - t0
    if m64["loss"].dtype != torch.float64:
        raise AssertionError(f"the f64 witness ran in {m64['loss'].dtype}")
    n64 = math.sqrt(sum(float((t.double() ** 2).sum()) for t in T.leaves(g64)))
    leaf_worst = max((a.double() - b).abs().max().item() / max(b.abs().max().item(), 1e-300)
                     for a, b in zip(T.leaves(g32), T.leaves(g64)))
    wit = dict(loss32=float(m32["loss"]), loss64=float(m64["loss"]), grad_norm32=n32,
               grad_norm64=n64, loss_rel=abs(float(m32["loss"]) - float(m64["loss"]))
               / abs(float(m64["loss"])), grad_norm_rel=abs(n32 - n64) / n64,
               leaf_worst=leaf_worst, s32=t32, s64=t64)
    out["13c_witness"] = wit
    print(f"    step-1 gradient, f32 against f64 on the card: loss {wit['loss32']:.7f} / "
          f"{wit['loss64']:.7f} (rel {wit['loss_rel']:.2e}, tol 1e-5); grad_norm "
          f"{n32:.6f} / {n64:.6f} (rel {wit['grad_norm_rel']:.2e}, tol 1e-4); worst leaf "
          f"{leaf_worst:.2e} * max|g64| (tol 1e-3); {t32:.2f} s f32, {t64:.2f} s f64 "
          f"(first calls)")
    if not (wit["loss_rel"] <= 1e-5 and wit["grad_norm_rel"] <= 1e-4 and leaf_worst <= 1e-3):
        failed.append(f"13c f64 witness: {wit}")
    del g32, g64, m32, m64
    gc.collect()
    torch.cuda.empty_cache()

    for proc, what in ((child, "13d"), (launch, "13e")):
        so, se = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"{what} exited {proc.returncode}:\n{so[-2000:]}\n{se[-4000:]}")
        if what == "13e":
            launch_out = so
    loop = json.loads((tmp / "loop.json").read_text())
    out["13d"] = loop
    print("[13d] the fault-tolerant loop at llama3.2-1b-smoke size on the card, deterministic "
          f"(CUBLAS_WORKSPACE_CONFIG=:4096:8): restarts {loop['restarts']}, steps run "
          f"{loop['steps_run']}, final params and moments bitwise the uninterrupted run's "
          f"{loop['bitwise']} ({loop['leaves']} leaves, all on cuda {loop['on_cuda']}); NaN "
          f"loss raised NanLossError {loop['nan_raised']}; checkpoint step "
          f"{loop['restored_step']} restored onto the CPU with the card's bits "
          f"{loop['cpu_bits']}; kernel launches {sum(loop['launches'].values())}")
    if not (loop["restarts"] == [0, 1] and loop["steps_run"] == [10, 12] and loop["bitwise"]
            and loop["on_cuda"] and loop["nan_raised"] and loop["restored_step"] == 10
            and loop["cpu_bits"] and not any(loop["launches"].values())):
        failed.append(f"13d: {loop}")
    lines = launch_out.strip().splitlines()
    out["13e"] = dict(lines=lines, joined_s=time.perf_counter() - t_launch)
    print(f"[13e] $ python -m repro_torch.launch.train {' '.join(launch_args[:-2])} (on the "
          f"card, beside 13a-13c; joined {out['13e']['joined_s']:.1f} s after its start)")
    for ln in lines:
        print(f"      {ln}")
    if not any("done: " in ln and "(1 restarts" in ln for ln in lines):
        failed.append(f"13e: no recovery in the launcher's output: {lines}")

    print("[13c] microbatch 2 against 1, then 8 steps on one batch (AdamW at a constant 3e-4, "
          "weight decay 0, updated in place)")
    opt = AdamW(lr=constant(3e-4), weight_decay=0.0)
    kernels.reset_launch_counts()
    runs = []
    for mb in (1, 2):
        p = T.map(torch.clone, params)
        runs.append(steps.make_train_step(model, cfg, opt, microbatch=mb, inplace=True)(
            p, opt.init(p), batch))
    rec, ok = _hold_step(torch, runs[0], runs[1], MICROBATCH_TOL, 3e-4, 0.0)
    out["13c_microbatch"] = rec
    print(f"    microbatch 2 against 1: worst rel loss {rec['loss']:.2e} grad_norm "
          f"{rec['grad_norm']:.2e} m {rec['m']:.2e} ({rec['m_leaf']}) v {rec['v']:.2e} params "
          f"{rec['params']:.2e} ({rec['loose']} near-eps elements, bounded "
          f"{rec['loose_bounded']}); tol {MICROBATCH_TOL:g}")
    if not ok:
        failed.append(f"13c microbatch: {rec}")
    del runs, p
    gc.collect()
    torch.cuda.empty_cache()
    step = steps.make_train_step(model, cfg, opt, inplace=True)
    opt_state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(8):
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))  # a host read: the step has ended
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    flops = 6 * n_params * T_tok
    bound_ms = train_step_bound_s(n_params, T_tok) * 1e3
    med = statistics.median(step_ms)
    run = dict(losses=losses, drop=losses[0] - losses[-1], step_ms=step_ms, median_ms=med,
               bound_ms=bound_ms, flops=flops, tokens_per_s=T_tok / (med / 1e3),
               peak_gib=(peak - held) / 2**30, held_gib=held / 2**30,
               params=n_params, launches=kernels.launch_counts())
    out["13c_train"] = run
    print(f"    losses {' '.join(f'{v:.4f}' for v in losses)}: drop {run['drop']:.4f} (at least "
          f"0.05)")
    print(f"    step ms {' '.join(f'{v:.1f}' for v in step_ms)}; median {med:.2f} ms against a "
          f"bound of {bound_ms:.2f} ms (6 N T = {flops / 1e12:.3f} TFLOP at 67 TFLOP/s plus "
          f"AdamW's 7 x 4 N bytes at 3.35 TB/s; {bound_ms / med:.1%} of it); "
          f"{run['tokens_per_s']:.0f} tokens/s; peak memory of the training {run['peak_gib']:.2f}"
          f" GiB (parameters, gradients, moments, activations; beside the "
          f"{run['held_gib']:.2f} GiB earlier phases hold); kernel launches "
          f"{sum(run['launches'].values())}")
    if not (run["drop"] >= 0.05 and all(math.isfinite(v) for v in losses)
            and not any(run["launches"].values())):
        failed.append(f"13c training: {run}")
    state = [params, opt_state]  # two more steps: a warm one and the profiled one

    def one_step():
        state[0], state[1], m = step(state[0], state[1], batch)
        float(m["loss"])

    prof = _profile(torch, one_step)
    out["13c_profile"] = prof
    _print_profile("a llama3.2-1b train step, batch 8 x 128", prof)
    if prof["measured"]:
        g_ = prof["library_gemm"]
        print(f"      cuBLAS GEMMs: {g_['ms']:.2f} ms over {g_['calls']} calls "
              f"({100 * g_['ms'] / prof['device_ms']:.1f}% of device time); "
              f"{flops / (g_['ms'] / 1e3) / 1e12:.1f} TFLOP/s on them")
    params, opt_state = state
    del params, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"    phase 13: {out['seconds']:.1f} s")
    if failed:
        raise AssertionError("phase 13: " + "; ".join(failed))
    return out


# phase 15's gate on the census's peak against the card's
PEAK_RATIO = (0.9, 1.1)


def phase15(torch, dev, p13):
    """Phase 15, the dry run against the card: 15a the census of phase 13c's
    train step, 15b of a dense decode step (FLOPs equal FlopCounterMode's on
    the card, peaks within PEAK_RATIO of the measured), 15c the bounds
    beside the measured step times, 15d the dry-run command line, 15e the
    port's quickstart example on the card."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapePreset
    from repro_torch.core import ops
    from repro_torch.core.op_census import census
    from repro_torch.core.roofline import PEAK_FLOPS, RooflineReport
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import cell_specs
    from repro_torch.models import build_model
    from repro_torch.models.modules import param_count
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedules import constant
    from repro_torch.parallel.sharding import make_rules

    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    dry_args = ["--arch", "llama3.2-1b", "--shape", "decode_32k", "--out",
                str(ROOT / "chiprun_out" / "dryrun")]
    dry = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *dry_args],
                           cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    quick = subprocess.Popen([sys.executable, str(ROOT / "examples" / "torch" / "quickstart.py")],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    out, failed = {}, []
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    rules = make_rules(make_mesh((1, 1), ("data", "model")))

    def bound(res, model_flops):
        return RooflineReport(hlo_flops=res.flops, hlo_bytes=res.floor_bytes,
                              collective_bytes=0.0, chips=1, model_flops=model_flops,
                              peak_flops=PEAK_FLOPS["float32"])

    print("[15a] the census of phase 13c's train step (llama3.2-1b, 8 x 128, f32, in-place "
          "AdamW) on meta against FlopCounterMode on the card and 13c's measured peak")
    opt = AdamW(lr=constant(3e-4), weight_decay=0.0)
    spec = cell_specs(cfg, ShapePreset("13c", 128, 8, "train"), rules,
                      param_dtype=torch.float32, opt=opt)
    step = steps.make_train_step(model, cfg, opt, inplace=True)
    t0 = time.perf_counter()
    cen, _ = census(step, *spec.args)
    census_s = time.perf_counter() - t0
    params = model.init(0, device=dev)
    n_params = param_count(params)
    batch = steps.batch_to(SyntheticLM(cfg, seq_len=128, global_batch=8, seed=0).next_batch(),
                           dev)
    state = opt.init(params)
    with FlopCounterMode(display=False) as fc:
        step(params, state, batch)
    torch.cuda.synchronize()
    card_flops = fc.get_total_flops()
    measured = p13["13c_train"]["peak_gib"] * 2**30
    tr = bound(cen, 6 * n_params * spec.tokens_per_step)
    out["15a"] = dict(census_flops=cen.flops, card_flops=card_flops,
                      census_peak_bytes=cen.peak_bytes, census_peak_live_bytes=cen.peak_live_bytes,
                      argument_bytes=cen.argument_bytes, floor_bytes=cen.floor_bytes,
                      op_bytes=cen.op_bytes, measured_peak_bytes=measured,
                      peak_ratio=cen.peak_bytes / measured, census_s=census_s,
                      roofline=tr.as_dict(), step_ms=p13["13c_train"]["median_ms"])
    a = out["15a"]
    print(f"    FLOPs: census {cen.flops} / FlopCounterMode on the card {card_flops} "
          f"(equal {cen.flops == card_flops}; 6 N T = {6 * n_params * spec.tokens_per_step:.4g})"
          f"; peak: census {cen.peak_bytes / 2**30:.3f} GiB (arguments "
          f"{cen.argument_bytes / 2**30:.3f} + live {cen.peak_live_bytes / 2**30:.3f}) / 13c "
          f"{measured / 2**30:.3f} GiB = {a['peak_ratio']:.4f} (gate {PEAK_RATIO}); census "
          f"{census_s:.1f} s on the host")
    if cen.flops != card_flops:
        failed.append(f"15a FLOPs: {a}")
    if not PEAK_RATIO[0] <= a["peak_ratio"] <= PEAK_RATIO[1]:
        failed.append(f"15a peak: {a}")
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()

    print("[15b] the census of llama3.2-1b's dense decode step (batch 8, 4096-position bf16 "
          "cache, f32 weights) on meta against the card, under MXPolicy(\"torch\")")
    dspec = cell_specs(cfg, ShapePreset("15b", 4096, 8, "decode"), rules,
                       param_dtype=torch.float32)
    serve = steps.make_serve_step(model, cfg)
    dcen, _ = census(serve, *dspec.args)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0, device=dev)
    cache = model.make_cache(8, 4096, device=dev)
    token = torch.zeros((8, 1), dtype=torch.int32, device=dev)
    index = dspec.args[3]
    with ops.use_policy(ops.MXPolicy("torch")):
        serve(params, cache, token, index)
        torch.cuda.synchronize()
        dmeasured = torch.cuda.max_memory_allocated() - held
        with FlopCounterMode(display=False) as fc:
            serve(params, cache, token, index)
        dcard = fc.get_total_flops()
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = serve(params, cache, token, index)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    if not (logits.shape == (8, 1, cfg.vocab) and torch.isfinite(logits).all()):
        failed.append(f"15b logits: {tuple(logits.shape)}")
    dr = bound(dcen, 2 * n_params * dspec.tokens_per_step)
    out["15b"] = dict(census_flops=dcen.flops, card_flops=dcard,
                      census_peak_bytes=dcen.peak_bytes, argument_bytes=dcen.argument_bytes,
                      census_peak_live_bytes=dcen.peak_live_bytes, floor_bytes=dcen.floor_bytes,
                      op_bytes=dcen.op_bytes, measured_peak_bytes=dmeasured,
                      peak_ratio=dcen.peak_bytes / dmeasured, roofline=dr.as_dict(),
                      step_ms=ms, step_ms_median=statistics.median(ms))
    b = out["15b"]
    print(f"    FLOPs: census {dcen.flops} / FlopCounterMode on the card {dcard} (equal "
          f"{dcen.flops == dcard}); peak: census {dcen.peak_bytes / 2**30:.3f} GiB (arguments "
          f"{dcen.argument_bytes / 2**30:.3f} + live {dcen.peak_live_bytes / 2**30:.3f}) / "
          f"measured {dmeasured / 2**30:.3f} GiB = {b['peak_ratio']:.4f} (gate {PEAK_RATIO})")
    if dcen.flops != dcard:
        failed.append(f"15b FLOPs: {b}")
    if not PEAK_RATIO[0] <= b["peak_ratio"] <= PEAK_RATIO[1]:
        failed.append(f"15b peak: {b}")
    del params, cache, token, logits
    gc.collect()
    torch.cuda.empty_cache()

    print("[15c] each step's roofline bound (census FLOPs at the f32 peak off the tensor "
          "cores, the floor bytes at 3.35 TB/s) beside its measured time; no gate")
    for what, r, t in (("13c train step", tr, a["step_ms"]),
                       ("15b decode step", dr, b["step_ms_median"])):
        print(f"    {what}: measured {t:.2f} ms; bound {r.step_time_lower_bound_s * 1e3:.2f} ms "
              f"({r.bound}: compute {r.compute_s * 1e3:.2f} ms, memory {r.memory_s * 1e3:.2f} "
              f"ms; {r.step_time_lower_bound_s * 1e3 / t:.1%} of the measured); useful FLOPs "
              f"{r.useful_flops_ratio:.4f}")

    so, se = dry.communicate(timeout=600)
    if dry.returncode != 0:
        raise AssertionError(f"15d dryrun exited {dry.returncode}:\n{so[-2000:]}\n{se[-4000:]}")
    rec = json.loads((ROOT / "chiprun_out" / "dryrun"
                      / "llama3.2-1b__decode_32k__1x1.json").read_text())
    total = torch.cuda.get_device_properties(0).total_memory
    m = rec["memory"]
    out["15d"] = dict(lines=so.strip().splitlines()[-3:], memory=m, total_memory=total,
                      roofline=rec["roofline"], cost={k: v for k, v in rec["cost"].items()
                                                     if not k.startswith("top_")})
    print(f"[15d] $ python -m repro_torch.launch.dryrun {' '.join(dry_args[:4])}")
    for ln in out["15d"]["lines"]:
        print(f"      {ln}")
    print(f"    fits_h100_80gb {m['fits_h100_80gb']}: peak {m['peak_bytes_per_device'] / 2**30:.2f}"
          f" GiB per device beside the card's total memory {total / 2**30:.2f} GiB")
    if rec["status"] != "ok" or "fits_h100_80gb=" not in so:
        failed.append(f"15d: {rec.get('status')}")

    so, se = quick.communicate(timeout=600)
    lines = so.strip().splitlines()
    out["15e"] = dict(rc=quick.returncode, lines=lines)
    kv = [ln for ln in lines if "kernel vs plain" in ln]
    print("[15e] $ python examples/torch/quickstart.py (on the card)")
    for ln in lines:
        if "kernel vs plain" in ln or "loss fell" in ln or "mx_matmul_fused" in ln:
            print(f"      {ln}")
    if quick.returncode != 0 or not kv or not kv[0].endswith(" ok"):
        failed.append(f"15e quickstart exited {quick.returncode}: {lines[-6:]} {se[-2000:]}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"    phase 15: {out['seconds']:.1f} s")
    if failed:
        raise AssertionError("phase 15: " + "; ".join(failed))
    return out


def _slice_tree(tree, n):
    """The first n layers of a layer-stacked tree."""
    if isinstance(tree, dict):
        return {k: _slice_tree(v, n) for k, v in tree.items()}
    return tree[:n]


# ---------------------------------------------------------------------------
# phase 14: the paper's analytics read against kernels 1 and 2
# ---------------------------------------------------------------------------

# llama3.2-1b's projections of a paged step: (name, K, N, kernel 1's epilogue)
LLAMA_PROJECTIONS = (("q", 2048, 2048, {}), ("k/v", 2048, 512, {}),
                     ("o+residual", 2048, 2048, dict(residual=True)),
                     ("up+gate swiglu", 2048, 8192, dict(activation="swiglu")),
                     ("down+residual", 8192, 2048, dict(residual=True)))
SHARE_LIMIT = 1.05  # a roofline share above it means a wrong count of bytes or FLOPs


def _medians(per: dict) -> dict:
    return {k: statistics.median(v) for k, v in per.items()}


def phase14_gemm(torch, dev, name, M, K, N, ep_kw, dtype_name, seed):
    """One projection on kernel 1 (with its epilogue) and kernel 2 (the bare
    GEMM, as the baseline serving path runs it): the priced plans, executed
    bytes, times, shares of the roofline bound and the paper's A/B."""
    from repro_torch.core import tiling
    from repro_torch.core.transfer_model import HopperGemmTiling
    from repro_torch.kernels import _build
    from repro_torch.kernels import mx_matmul as mm
    from repro_torch.kernels.baseline_matmul import baseline_matmul
    from repro_torch.kernels.quant import launch_gemm_bytes
    from repro_torch.kernels.ref import baseline_matmul_ref

    dt = getattr(torch, dtype_name)
    ep = mm.Epilogue(**ep_kw)
    gated = ep.has_gate
    g = torch.Generator(device=dev).manual_seed(seed)

    def make():
        a = torch.randn((M, K), generator=g, device=dev).to(dt)
        b = (torch.randn((K, N), generator=g, device=dev) / math.sqrt(K)).to(dt)
        bg = (torch.randn((K, N), generator=g, device=dev) / math.sqrt(K)).to(dt) if gated else None
        r = torch.randn((M, N), generator=g, device=dev).to(dt) if ep.residual else None
        return a, b, bg, r

    el = dt.itemsize
    mats = 2 if gated else 1
    path_bytes = el * (M * K + mats * K * N + M * N * (2 if ep.residual else 1))
    path_flops = 2 * M * N * K * mats
    bare_bytes, bare_flops = el * (M * K + K * N + M * N), 2 * M * N * K
    sets = [make() for _ in range(_copies(path_bytes))]
    a, b, bg, r = sets[0]
    path = lambda a_, b_, bg_, r_: mm.mx_matmul_fused(a_, b_, epilogue=ep, b_gate=bg_,  # noqa: E731
                                                      residual=r_)
    bare = lambda a_, b_, bg_, r_: mm.mx_matmul_fused(a_, b_)  # noqa: E731
    base = lambda a_, b_, bg_, r_: baseline_matmul(a_, b_)  # noqa: E731
    errs = {
        "kernel 1": _err(torch, path(a, b, bg, r),
                         mm.mx_matmul_fused_plain(a, b, epilogue=ep, b_gate=bg, residual=r),
                         dtype_name),
        "kernel 2": _err(torch, base(a, b, bg, r),
                         baseline_matmul_ref(a, b, tiling.BASELINE_BK, dt), dtype_name)}
    fns = {"kernel 1": (path, sets), "kernel 2": (base, sets)}
    if ep_kw:
        fns["kernel 1 bare"] = (bare, sets)
    ms = _medians(_time_ms(torch, fns)["windows_ms"])
    ms.setdefault("kernel 1 bare", ms["kernel 1"])
    ops_ = int(ep.residual) + int(ep.activation != "none")
    plan1 = tiling.plan_matmul_tiles(M, N, K, dt, dt, gated=gated, fused_epilogue_ops=ops_)
    bare1 = tiling.plan_matmul_tiles(M, N, K, dt, dt)
    plan2 = tiling.plan_matmul_tiles(M, N, K, dt, dt, "baseline")
    t = bare1.tiling  # the paper's A/B at kernel 1's launched tile, bk = 128 round trips
    unbuffered = HopperGemmTiling(t.bm, t.bn, tiling.BASELINE_BK,
                                  accumulate_in_registers=False, route=t.route,
                                  stages=t.stages, ring_bk=t.bk).hbm_bytes(bare1.problem)
    b1, by1 = _bound_ms(path_bytes, path_flops, dtype_name)
    b2, by2 = _bound_ms(bare_bytes, bare_flops, dtype_name)
    rec = dict(
        name=name, M=M, K=K, N=N, dtype=dtype_name, epilogue=ep_kw,
        plan_kernel1={k: getattr(plan1, k) for k in (
            "route", "bm", "bn", "bk", "stages", "split", "parts", "ctas", "smem_bytes",
            "acc_bytes", "hbm_bytes", "epilogue_saved_bytes")},
        plan_kernel2={k: getattr(plan2, k) for k in (
            "route", "bm", "bn", "bk", "stages", "split", "parts", "ctas", "smem_bytes",
            "acc_bytes", "hbm_bytes")},
        executed_bytes_kernel1=launch_gemm_bytes(a, b, b_gate=bg),
        executed_bytes_kernel2=launch_gemm_bytes(a, b, variant="baseline"),
        flops_kernel1=path_flops, flops_kernel2=bare_flops,
        bytes_kernel1=path_bytes, bytes_kernel2=bare_bytes, ms=ms,
        bound_ms_kernel1=b1, bound_by_kernel1=by1, bound_ms_kernel2=b2, bound_by_kernel2=by2,
        share_kernel1=b1 / ms["kernel 1"], share_kernel2=b2 / ms["kernel 2"],
        model_mx_bytes=bare1.hbm_bytes, model_baseline_bytes=unbuffered,
        model_ratio=unbuffered / bare1.hbm_bytes,
        time_ratio=ms["kernel 2"] / ms["kernel 1 bare"],
        err={k: dict(err=e, tol=tol) for k, (e, tol) in errs.items()})
    rec["ok"] = (max(plan1.smem_bytes, plan2.smem_bytes) <= _build.SMEM_PER_CTA
                 and max(rec["share_kernel1"], rec["share_kernel2"]) <= SHARE_LIMIT
                 and rec["model_mx_bytes"] < rec["model_baseline_bytes"]
                 and all(e <= tol for e, tol in errs.values()))
    return rec


def phase14_decode(torch, dev):
    """14c: mx_flash_decode at phase 3's shape against the transfer model's
    paged step (`PagedKVDecode.paged_step_bytes` through
    `kv_decode_memory_s`), beside phase 3's own bound."""
    from repro_torch.core.roofline import kv_decode_memory_s
    from repro_torch.core.transfer_model import PagedKVDecode
    from repro_torch.kernels.mx_flash_decode import mx_flash_decode

    B, H, Hkv, d, ps = 8, 32, 8, 64, 16
    lengths = (128, 160, 0, 97, 143, 1, 129, 150)  # phase 3's
    sets, table, lns, W, nbytes = _attn_inputs(torch, dev, B, H, Hkv, d, ps, lengths,
                                                "float32", 100, False, "same")
    ms = _time_ms(torch, {"ms": (lambda q_, k_, v_, kw_: mx_flash_decode(
        q_, k_, v_, table, lns, **kw_), sets)})["ms"]
    model = PagedKVDecode(batch_slots=B, max_len=W * ps, page_size=ps, n_kv_heads=Hkv,
                          head_dim=d, kv_bytes=4)
    step_bytes = model.paged_step_bytes(lengths)
    model_ms = kv_decode_memory_s(step_bytes) * 1e3
    phase3_ms, by = _bound_ms(nbytes, 4 * sum(lengths) * H * d, "float32")
    live = sum(lengths)
    resident = sum(-(-ln // ps) * ps for ln in lengths if ln)
    active = sum(1 for ln in lengths if ln)
    q_out = 2 * 4 * B * H * d
    rec = dict(B=B, H=H, Hkv=Hkv, d=d, page_size=ps, lengths=list(lengths), ms=ms,
               model_bytes=step_bytes, model_bound_ms=model_ms, phase3_bytes=nbytes,
               phase3_bound_ms=phase3_ms, phase3_bound_by=by,
               bytes_difference=step_bytes - nbytes,
               whole_page_rows=(resident - live) * model.row_bytes,
               new_row_writes=active * model.row_bytes, q_and_output=q_out,
               table_and_lengths=nbytes - q_out - 2 * 4 * live * Hkv * d,
               share=model_ms / ms)
    rec["ok"] = rec["share"] <= SHARE_LIMIT and (
        rec["bytes_difference"] == rec["whole_page_rows"] + rec["new_row_writes"]
        - rec["q_and_output"] - rec["table_and_lengths"])
    return rec


def phase14(torch, dev):
    """The paper's analytics at llama3.2-1b's full width, read against
    kernels 1 and 2 and the paged attention (see the module docstring)."""
    from repro_torch import kernels

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    rows, seed = [], 1400
    for dtype_name in ("float32", "bfloat16"):
        for M in (8, 64):
            for name, K, N, ep_kw in LLAMA_PROJECTIONS:
                seed += 1
                rows.append(phase14_gemm(torch, dev, name, M, K, N, ep_kw, dtype_name, seed))
    print("    14a/14b  proj            M  dtype     kernel-1 plan (route bm x bn x bk, "
          "stages, split, parts, smem, acc)   exec bytes   GFLOP    ms      share | kernel 2 "
          "ms  share | model bytes MX / no inter-k buffering = ratio | time k2 / k1")
    for c in rows:
        p1 = c["plan_kernel1"]
        print(f"    {c['name']:16s} {c['M']:3d} {c['dtype']:9s} {p1['route']:6s} "
              f"{p1['bm']} x {p1['bn']} x {p1['bk']}, {p1['stages']}, {p1['split']}, "
              f"{p1['parts']}, {p1['smem_bytes']}, {p1['acc_bytes']}  "
              f"{c['executed_bytes_kernel1']:11d} {c['flops_kernel1'] / 1e9:7.3f} "
              f"{c['ms']['kernel 1']:.4f} {c['share_kernel1']:.3f} ({c['bound_by_kernel1'][0]}) | "
              f"{c['ms']['kernel 2']:.4f} {c['share_kernel2']:.3f} | {c['model_mx_bytes']} / "
              f"{c['model_baseline_bytes']} = {c['model_ratio']:.3f} | {c['time_ratio']:.3f}"
              f"{'' if c['ok'] else '  FAIL'}")
    dec = phase14_decode(torch, dev)
    launches = kernels.launch_counts()
    tiles = dict(decode=kernels.decode_launch_counts(), prefill=kernels.prefill_launch_counts())
    print(f"    14c mx_flash_decode B=8 H=32 Hkv=8 d=64, lengths to 160, f32 pages: "
          f"{dec['ms']:.4f} ms; PagedKVDecode.paged_step_bytes {dec['model_bytes']} B -> "
          f"kv_decode_memory_s {dec['model_bound_ms']:.5f} ms (share {dec['share']:.3f}); "
          f"phase 3's bound {dec['phase3_bound_ms']:.5f} ms ({dec['phase3_bytes']} B); the "
          f"model {dec['bytes_difference']:+d} B: whole pages +{dec['whole_page_rows']}, the "
          f"new rows' writes +{dec['new_row_writes']}, no q / output -{dec['q_and_output']}, "
          f"no table / lengths -{dec['table_and_lengths']}{'' if dec['ok'] else '  FAIL'}")
    seconds = time.perf_counter() - t0
    print(f"    phase 14: {len(rows)} projections, launches kernel 1 "
          f"{launches['mx_matmul_fused']} (decode tile {tiles['decode']['mx_matmul_fused']}, "
          f"prefill tile {tiles['prefill']['mx_matmul_fused']}), kernel 2 "
          f"{launches['baseline_matmul']}, mx_flash_decode {launches['mx_flash_decode']}; "
          f"{seconds:.1f} s")
    bad = [c for c in rows if not c["ok"]] + ([dec] if not dec["ok"] else [])
    if bad or not all(launches[k] for k in ("mx_matmul_fused", "baseline_matmul",
                                            "mx_flash_decode")):
        raise AssertionError(f"phase 14 failed: {bad or launches}")
    return dict(gemms=rows, decode=dec, launches=launches, tile_launches=tiles,
                seconds=seconds)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this smoke test needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1] device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    build_s = _build.build_all(variants=[GROUPED_COPIES])
    print(f"[2] built {len(_build.SOURCES)} CUDA sources for sm_90a in {build_s:.1f} s; "
          f"nvcc CPU s per source {_build.NVCC_CPU_SECONDS}")
    ptxas = []
    for name in _build.SOURCES:
        entry = ""
        for line in _build.ptxas_report(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1][:48]  # the mangled kernel name
            elif "registers" in line or "spill" in line:
                ptxas.append(f"{name} {entry}: {line.strip()}")
                print(f"    {ptxas[-1]}")
    sass = sass_rmw_counts()
    print(f"    output read-modify-write in the SASS (ld/st.global.cg = *.STRONG.GPU): "
          f"{sass}")
    if not (sass["baseline_matmul"][0] and sass["baseline_matmul"][1]):
        raise AssertionError("the baseline kernel's output round trip was compiled away")
    if any(sass["mx_matmul_fused"]):
        raise AssertionError(f"the MX library round-trips its output: {sass}")
    mma_sass = sass_mma_counts(PREFILL_LIBS, "prefill_kernel")
    bad_sass = {k: c for k, c in mma_sass.items() if not c["mma"]
                or ("abft" not in k and c["ffma"] > PREFILL_MAX_FFMA)
                or (byte_pair(k) == "int8" and not c["mma8"])}
    if len(mma_sass) < 4 or bad_sass:
        raise AssertionError(f"prefill kernels off the tensor cores: {bad_sass or mma_sass}")
    _print_byte_sass("prefill", mma_sass)
    # the grouped GEMM's "mma" route: every instantiation (dense, 2:4, ABFT)
    # holds tensor-core instructions, and outside ABFT no more FFMAs than
    # the prefill kernels
    grouped_sass = sass_mma_counts(GROUPED_LIBS, "grouped_mma_kernel")
    bad_sass = {k: c for k, c in grouped_sass.items() if not c["mma"]
                or ("abft" not in k and c["ffma"] > PREFILL_MAX_FFMA)
                or (byte_pair(k) == "int8" and not c["mma8"])}
    _print_byte_sass("grouped", grouped_sass)
    print(f"    grouped mma SASS: {len(grouped_sass)} kernels, tensor-core instructions "
          f"{min(c['mma'] for c in grouped_sass.values()) if grouped_sass else 0} or more "
          f"each, FFMAs at most "
          f"{max((c['ffma'] for k, c in grouped_sass.items() if 'abft' not in k), default=0)}"
          f" outside ABFT")
    if len(grouped_sass) < 3 or bad_sass:
        raise AssertionError(f"grouped kernels off the tensor cores: {bad_sass or grouped_sass}")
    attn_sass = sass_mma_counts(("mx_flash_attention",), "flash_attention_kernel")
    print(f"    mx_flash_attention SASS: {len(attn_sass)} kernels, tensor-core instructions "
          f"{min(c['mma'] for c in attn_sass.values()) if attn_sass else 0} or more each")
    if len(attn_sass) < 32 or not all(c["mma"] for c in attn_sass.values()):
        raise AssertionError(f"flash attention kernels off the tensor cores: {attn_sass}")

    ssd_sass = sass_mma_counts(("ssd_scan",), "ssd_scan_kernel")
    print(f"    ssd_scan SASS: {len(ssd_sass)} kernels, tensor-core instructions "
          f"{min(c['mma'] for c in ssd_sass.values()) if ssd_sass else 0} or more each")
    if len(ssd_sass) < 2 or not all(c["mma"] for c in ssd_sass.values()):
        raise AssertionError(f"ssd_scan kernels off the tensor cores: {ssd_sass}")

    print("[3] kernels against their plain versions")
    checks = phase_kernels(torch, dev)
    checks += ssd_flash_checks(torch, dev)
    print("[3a] the ABFT kernels: clean bitwise, faults flagged, flag maps = plain, "
          "recovery bitwise")
    abft_checks_ = abft_checks(torch, dev)
    print("[14] the paper's analytics read against kernels 1 and 2, llama3.2-1b's projections "
          "(core/tiling, core/transfer_model, core/roofline, kernels/quant)")
    p14 = phase14(torch, dev)

    # zamba2 serves first: its times come before any profiler session
    zamba2, zmodel, zparams = zamba2_phase(torch, dev)
    launches, llama = llama_phases(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()  # llama's weights and caches are gone
    grok = grok_phases(torch, dev)
    launches["mx_grouped_matmul"] = grok["serve"]["launches"]["mx_grouped_matmul"]
    launches.update(zamba2["launches"])
    # grok is freed: the three families, one model at a time
    families = family_phases(torch, dev)
    # llama again, its serving under faults, then tensor parallelism on the
    # same weights: before the zamba2 profile below
    p11, p12 = phase11(torch, dev, then=lambda model, params, cfg: phase12(
        torch, dev, model, params, cfg, llama["serve"]["step_ms_median"]))
    gc.collect()
    torch.cuda.empty_cache()
    p13 = phase13(torch, dev)
    p15 = phase15(torch, dev, p13)
    print("[8p] zamba2-2.7b decode step and full forward profiled")
    zamba2["profile_decode"], zamba2["profile_forward"] = zamba2_profile(torch, dev, zmodel,
                                                                          zparams)
    del zmodel, zparams

    headline = {  # a decode-step call of each kernel on the main path, f32
        # the down projection: one library call (addmm) computes the same function
        "mx_matmul_fused": dict(M=8, K=8192, N=2048, epilogue=dict(residual=True)),
        "baseline_matmul": dict(M=8, K=2048, N=8192),
        "mx_flash_decode": dict(B=8, H=32, poison=False, pages="same", label=None),
        # the llama decode window (k = 4): f32 q and pages
        "mx_flash_verify": dict(B=8, H=32, S=5, poison=False, pages="same"),
        # grok's decode down projection: one library call (bmm) computes it
        "mx_grouped_matmul": dict(label="grok decode down"),
        # every Mamba2 layer of zamba2's forward: 8 x 80 heads (no library call)
        "ssd_scan": dict(label="zamba2 L=512"),
        # zamba2's shared block, causal: one library call (SDPA) computes it
        "mx_flash_attention": dict(label="zamba2 shared block"),
    }
    summary = []
    for name, sel in headline.items():
        c = next(c for c in checks if c["kernel"] == name and c["dtype"] == "float32"
                 and all(c.get(k) == v for k, v in sel.items()))
        summary.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=TPU_KERNELS[name],
            launches=launches[name], max_abs_err=c["max_abs_err"], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            library_ms=c["library_ms"],
            shape={k: c[k] for k in ("M", "T", "G", "K", "N", "B", "S", "H", "Hkv", "d",
                                     "L", "P", "chunk", "Lq", "Lk") if k in c},
            dtype="float32"))
    # the quantized variants (stages 1b, 5b, fp8 pages): a decode-step call
    # each, with its launches in the serving run that takes it
    qruns = llama["quant"]["serve"]
    variants = (  # (name, kernel, check selector, launches)
        ("mx_matmul_fused (bf16 x int8)", "mx_matmul_fused",
         dict(dtype="int8", M=8, K=8192, N=2048, epilogue={}),
         qruns["(d) int8"]["launches"]["mx_matmul_fused"]),
        # run (e)'s launches split by tile: the decode tile's here, the
        # prefill tile's under the entry of that tile below
        ("mx_matmul_fused (int8 x int8)", "mx_matmul_fused",
         dict(dtype="int8_all", M=8, K=8192, N=2048),
         qruns["(e) int8_all"]["decode_launches"]["mx_matmul_fused"]),
        ("mx_matmul_fused (bf16 x fp8)", "mx_matmul_fused",
         dict(dtype="fp8", M=8, K=8192, N=2048),
         qruns["(f) fp8 + fp8 pages"]["launches"]["mx_matmul_fused"]),
        ("mx_flash_decode (fp8 pages)", "mx_flash_decode",
         dict(dtype="float32", B=8, H=32, poison=False, pages="fp8", label=None),
         qruns["(f) fp8 + fp8 pages"]["launches"]["mx_flash_decode"]),
        ("mx_flash_verify (fp8 pages)", "mx_flash_verify",
         dict(dtype="float32", B=8, H=32, S=5, poison=False, pages="fp8"),
         qruns["(f) fp8 + fp8 pages spec4 ngram"]["launches"]["mx_flash_verify"]),
        ("mx_grouped_matmul (bf16 x int8)", "mx_grouped_matmul",
         dict(dtype="int8", label="grok decode down"),
         grok["quant"]["serve"]["launches"]["mx_grouped_matmul"]),
        # stage 1c / 5c: the 2:4 variants, launches from the sparse serving runs
        ("mx_matmul_fused (2:4, f32)", "mx_matmul_fused",
         dict(variant="sparse", dtype="sparse24 f32", M=8, K=8192, N=2048, epilogue={}),
         llama["sparse"]["serve"]["(g) sparse24"]["variants"]["mx_matmul_fused sparse"]),
        ("mx_matmul_fused (2:4, bf16 x int8)", "mx_matmul_fused",
         dict(variant="sparse", dtype="sparse24_int8", M=8, K=8192, N=2048, epilogue={}),
         llama["sparse"]["serve"]["(h) sparse24_int8"]["variants"]["mx_matmul_fused sparse"]),
        ("mx_grouped_matmul (2:4, bf16 x int8)", "mx_grouped_matmul",
         dict(variant="sparse", dtype="sparse24_int8", label="grok decode down"),
         grok["sparse"]["serve"]["variants"]["mx_grouped_matmul sparse"]),
        # stage 1d / 5d: the ABFT variants, launches from the ABFT serving runs
        ("mx_matmul_fused (ABFT, f32)", "mx_matmul_fused", dict(variant="abft", dtype="f32"),
         llama["abft"]["serve"]["variants"]["mx_matmul_fused abft"]),
        ("mx_grouped_matmul (ABFT, f32)", "mx_grouped_matmul",
         dict(variant="abft", dtype="f32"),
         grok["abft"]["serve"]["variants"]["mx_grouped_matmul abft"]),
        # this slice: the flash attention kernel on the llama draft forward
        # (its launches in the phase 4 draft-model run)
        ("mx_flash_attention (llama draft)", "mx_flash_attention",
         dict(label="llama draft", dtype="float32"),
         llama["serve_spec"]["draft-model spec4"]["launches"]["mx_flash_attention"]),
        # the 8-bit tensor-core prefill tile: a 64-row chunk's down projection
        # under "int8_all", its launches those of run (e) on the prefill tile
        ("mx_matmul_fused (int8 x int8, prefill tile)", "mx_matmul_fused",
         dict(dtype="int8_all", M=64, K=8192, N=2048, epilogue=dict(residual=True)),
         qruns["(e) int8_all"]["prefill_tile_launches"]["mx_matmul_fused"]))
    e = qruns["(e) int8_all"]
    if (e["decode_launches"]["mx_matmul_fused"] + e["prefill_tile_launches"]["mx_matmul_fused"]
            != e["launches"]["mx_matmul_fused"]):
        raise AssertionError(f"run (e)'s kernel 1 launches are not its decode and prefill "
                             f"tiles' alone: {e['fused_by_route']}")
    for name, kernel, sel, n in variants:
        if n <= 0:
            raise AssertionError(f"{name} was not launched on its serving path")
        c = next(c for c in checks + abft_checks_ if c["kernel"] == kernel
                 and all(c.get(k) == v for k, v in sel.items()))
        variant = sel.get("variant")
        summary.append(dict(
            name=name, route="cuda", source=SOURCES[kernel if variant is None
                                                     else f"{kernel} {variant}"],
            replaces=TPU_KERNELS[kernel],
            launches=n, max_abs_err=c["max_abs_err"], ms=c["ms"], plain_ms=c["plain_ms"],
            bound_ms=c["bound_ms"], bound_by=c["bound_by"], library_ms=c["library_ms"],
            shape={k: c[k] for k in ("M", "T", "G", "K", "N", "B", "S", "H", "Hkv", "d",
                                     "Lq", "Lk") if k in c},
            dtype=c.get("pair", c["dtype"])))
    # this slice: the tensor-core prefill tile, a prefill chunk's down
    # projection, its launches those of the main serving run on the tile
    for name, kernel, sel, n in (
            ("mx_matmul_fused (prefill tile, f32)", "mx_matmul_fused",
             dict(dtype="float32", M=64, K=8192, N=2048, epilogue=dict(residual=True)),
             llama["serve"]["prefill_tile_launches"]["mx_matmul_fused"]),
            ("baseline_matmul (prefill tile, f32)", "baseline_matmul",
             dict(dtype="float32", M=64),
             llama["serve_baseline"]["prefill_tile_launches"]["baseline_matmul"])):
        c = next(c for c in checks if c["kernel"] == kernel
                 and all(c.get(k) == v for k, v in sel.items()))
        summary.append(dict(
            name=name, route="cuda", source="src/repro_torch/csrc/prefill_tile.cuh",
            replaces=TPU_KERNELS[kernel], launches=n, max_abs_err=c["max_abs_err"],
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"],
            shape={k: c[k] for k in ("M", "K", "N") if k in c}, dtype="float32"))
    # phase 10: the new shapes of the kernels on the three families' paths,
    # their launches those of the phase's runs
    fam = families
    for name, kernel, sel, n in (
            ("mx_matmul_fused (xlstm decode q/k/v)", "mx_matmul_fused",
             dict(dtype="float32", M=8, K=1536, N=1536, epilogue={}),
             fam["xlstm"]["serve"]["cuda_mx"]["decode_launches"]["mx_matmul_fused"]),
            ("mx_flash_attention (seamless encoder, non-causal)", "mx_flash_attention",
             dict(dtype="float32", label="seamless encoder"),
             fam["seamless"]["launches"]["mx_flash_attention"]),
            ("mx_flash_attention (seamless cross at decode, Lq=1)", "mx_flash_attention",
             dict(dtype="float32", label="seamless cross decode"),
             fam["seamless"]["decode"]["launches"]["mx_flash_attention"]),
            ("mx_flash_attention (internvl2, d=128, 48/8 heads)", "mx_flash_attention",
             dict(dtype="float32", label="internvl2 forward"),
             fam["internvl2"]["launches"]["mx_flash_attention"])):
        if n <= 0:
            raise AssertionError(f"{name} was not launched on its path")
        c = next(c for c in checks if c["kernel"] == kernel
                 and all(c.get(k) == v for k, v in sel.items()))
        summary.append(dict(
            name=name, route="cuda", source=SOURCES[kernel], replaces=TPU_KERNELS[kernel],
            launches=n, max_abs_err=c["max_abs_err"], ms=c["ms"], plain_ms=c["plain_ms"],
            bound_ms=c["bound_ms"], bound_by=c["bound_by"], library_ms=c["library_ms"],
            shape={k: c[k] for k in ("M", "K", "N", "B", "H", "Hkv", "d", "Lq", "Lk")
                   if k in c}, dtype="float32"))
    # phase 11: the kernels of the disaggregated and chaos paths, at the
    # shapes they run there (4 decode slots, a worker's 64-row chunk), their
    # launches those of the phase's runs
    for name, kernel, sel, n in (
            ("mx_matmul_fused (disagg decode, 4 slots)", "mx_matmul_fused",
             dict(dtype="float32", M=4, K=8192, N=2048, epilogue=dict(residual=True)),
             p11["11a"]["decode"]["mx_matmul_fused"]),
            ("mx_matmul_fused (disagg worker chunk, prefill tile)", "mx_matmul_fused",
             dict(dtype="float32", M=64, K=8192, N=2048, epilogue=dict(residual=True)),
             p11["11a"]["prefill_tile"]["mx_matmul_fused"]),
            ("mx_flash_decode (disagg, 4 slots)", "mx_flash_decode",
             dict(dtype="float32", B=4, label="4 slots"),
             p11["11a"]["launches"]["mx_flash_decode"]),
            ("mx_matmul_fused (ABFT under chaos)", "mx_matmul_fused",
             dict(variant="abft", dtype="f32"), p11["11d"]["variants"]["mx_matmul_fused abft"]),
            ("mx_flash_verify (spec4 under chaos)", "mx_flash_verify",
             dict(dtype="float32", B=8, H=32, S=5, poison=False, pages="same"),
             p11["11e"]["launches"]["mx_flash_verify"])):
        if n <= 0:
            raise AssertionError(f"{name} was not launched on its path")
        c = next(c for c in checks + abft_checks_ if c["kernel"] == kernel
                 and all(c.get(k) == v for k, v in sel.items()))
        variant = sel.get("variant")
        summary.append(dict(
            name=name, route="cuda",
            source=SOURCES[kernel if variant is None else f"{kernel} {variant}"],
            replaces=TPU_KERNELS[kernel], launches=n, max_abs_err=c["max_abs_err"], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            library_ms=c["library_ms"],
            shape={k: c[k] for k in ("M", "K", "N", "B", "S", "H", "Hkv", "d") if k in c},
            dtype=c.get("pair", c["dtype"])))
    # phase 12: kernel 1 as the ring GEMMs' chunk GEMMs, each row at a decode
    # step's projection (the rings 12c (ii) runs most), its launches those
    # of 12c (ii) in that mode
    for mode, name, line in (
            ("allgather", "mx_matmul_fused (ring all-gather chunk)", 196),
            ("reduce_scatter", "mx_matmul_fused (ring reduce-scatter chunk)", 380)):
        n = p12["12c_serve"]["ring"][f"{mode}_chunks"]
        if n <= 0:
            raise AssertionError(f"{name} was not launched on its path")
        label, direction = RING_ROWS[mode]
        c = next(c for c in p12["12a"] if c["mode"] == mode and c["label"] == label
                 and c["direction"] == direction)
        summary.append(dict(
            name=name, route="cuda", source=SOURCES["mx_matmul_fused"],
            replaces=f"src/repro/kernels/mx_collective_matmul.py:{line}", launches=n,
            max_abs_err=c["max_abs_err"], ms=c["ms"], plain_ms=c["plain_ms"],
            bound_ms=c["bound_ms"], bound_by=c["bound_by"], library_ms=c["library_ms"],
            shape={k: c[k] for k in ("M", "K", "N")}, dtype="float32",
            ring=f"LocalRing({RING_P}) {direction}", kernel_whole_ms=c["kernel_ms"]))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        device=smi, build_s=build_s, nvcc_cpu_s=_build.NVCC_CPU_SECONDS, ptxas=ptxas,
        checks=checks, abft_checks=abft_checks_, prefill_sass=mma_sass,
        grouped_sass=grouped_sass,
        attention_sass=attn_sass, ssd_sass=ssd_sass,
        **llama, grok=grok, zamba2=zamba2, families=families, phase11=p11, phase12=p12,
        phase13=p13, phase14=p14, phase15=p15,
        kernels=summary),
        indent=1,
        default=str))
    print("prefill tile SASS (tensor-core / FFMA instructions per kernel): " + "; ".join(
        f"{k.split(':')[0]} {k.split(':')[1][:40]} {c['mma']}/{c['ffma']}"
        for k, c in mma_sass.items()))
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def sass_rmw_counts():
    """(loads, stores) marked .STRONG.GPU -- what ld/st.global.cg compile to
    -- in each GEMM library's SASS: the baseline must keep its per-chunk
    output round trip, the MX kernel has none."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    out = {}
    for name, lib in (("mx_matmul_fused", "mx_matmul"),
                      ("baseline_matmul", "baseline_matmul")):
        text = subprocess.run([str(cuobjdump), "-sass", str(_build._target(lib))],
                              capture_output=True, text=True, check=True).stdout
        lines = [ln for ln in text.splitlines() if "STRONG.GPU" in ln]
        # LDG / STG only: the decode tile's LDGSTS (cp.async) is no round trip
        out[name] = (sum(" LDG." in ln for ln in lines), sum(" STG." in ln for ln in lines))
    return out


TENSOR_CORE_OPS = ("HMMA", "HGMMA", "IMMA", "IGMMA", "QMMA", "QGMMA")
BYTE_MMA_OPS = ("IMMA", "IGMMA", "QMMA", "QGMMA")  # the 8-bit tensor-core products


def byte_pair(kernel: str):
    """"int8" or "fp8" for a prefill or grouped kernel instantiated on the
    8-bit pairs (int8_t x int8_t, __nv_fp8_e4m3 x __nv_fp8_e4m3, read from
    the mangled template arguments), else None."""
    if re.search(r"[IE]aaL", kernel):
        return "int8"
    if re.search(r"13__nv_fp8_e4m3S\d*_", kernel):
        return "fp8"
    return None


def sass_mma_counts(libs, marker):
    """Per kernel whose mangled name holds `marker` in each of `libs`, its
    tensor-core (HMMA / HGMMA / IMMA / IGMMA / QMMA / QGMMA: "mma"; of
    those the 8-bit ones: "mma8"), f32 FMA (FFMA) and conversion (F2FP)
    instructions in the SASS, and each of HMMA, IMMA, QMMA on its own.  The
    prefill tiles (csrc/prefill_tile.cuh): the K loop's products run on the
    tensor cores, the FFMAs left are the epilogue's (activations) and the
    ABFT checksums'.  The flash attention: both products on the tensor
    cores."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    out = {}
    for lib in libs:
        text = subprocess.run([str(cuobjdump), "-sass", str(_build._target(lib))],
                              capture_output=True, text=True, check=True).stdout
        name = None
        for line in text.splitlines():
            if "Function : " in line:
                name = line.split("Function : ")[1].strip()
                if marker in name:
                    out[f"{lib}:{name}"] = dict(mma=0, mma8=0, ffma=0, f2fp=0, HMMA=0,
                                                IMMA=0, QMMA=0)
                else:
                    name = None
            elif name is not None:
                op = line.split("*/")[1].split() if "*/" in line else []
                op = op[0] if op and not op[0].startswith("@") else (op[1] if len(op) > 1
                                                                     else "")
                c = out[f"{lib}:{name}"]
                c["mma"] += op.startswith(TENSOR_CORE_OPS)
                c["mma8"] += op.startswith(BYTE_MMA_OPS)
                c["ffma"] += op.startswith("FFMA")
                c["f2fp"] += op.startswith("F2FP")
                for k in ("HMMA", "IMMA", "QMMA"):
                    c[k] += op.startswith(k)
    return out


def _print_byte_sass(what, counts):
    """The 8-bit pairs' instantiations of a family of kernels: how many, and
    the fewest tensor-core products and 8-bit ones (IMMA / QMMA ...) and the
    most FFMAs (outside ABFT) any of them holds.  int8 x int8 must hold
    IMMA; e4m3 x e4m3 runs f16 HMMAs of its exactly widened operands (sm_90
    has no e4m3 mma.sync of its own: it lowers one to the same)."""
    for pair in ("int8", "fp8"):
        ks = {k: c for k, c in counts.items() if byte_pair(k) == pair}
        print(f"    {what} {pair} x {pair} SASS: {len(ks)} kernels, tensor-core "
              f"instructions {min((c['mma'] for c in ks.values()), default=0)} or more each, "
              f"8-bit ones {min((c['mma8'] for c in ks.values()), default=0)} or more, "
              f"FFMAs at most "
              f"{max((c['ffma'] for k, c in ks.items() if 'abft' not in k), default=0)} "
              f"outside ABFT")
        if not ks:
            raise AssertionError(f"no {what} kernel instantiated on {pair} x {pair}")


def _print_serve(r):
    print(f"    [{r['label']}] {r['requests']} requests x {r['gen']} new tokens through "
          f"{r['slots']} slots: {r['wall_s']:.2f} s, {r['generated_tok_per_s']:.1f} "
          f"generated tok/s ({r['total_tok_per_s']:.1f} incl. prompt), "
          f"{r['steps']} steps + {r['prefill_launches']} prefill chunks")
    print(f"      TTFT {r['ttft_steps_mean']:.1f} steps mean / {r['ttft_steps_max']} max, "
          f"{r['ttft_ms_mean']:.1f} ms mean / {r['ttft_ms_max']:.1f} ms max; median step "
          f"without admission {r['step_ms_median'] or float('nan'):.2f} ms "
          f"({r['steps_without_admission']} steps)")
    p, x = r["pool"], r["prefix"]
    print(f"      pool high water {p['high_water']}/{p['num_pages']} pages; prefix hits "
          f"{x['hits']}/{x['hits'] + x['misses']}, {x['tokens_saved']} tokens skipped, "
          f"{x['cow_copies']} COW copies, {x['evicted_pages']} evicted")
    print(f"      launches {r['launches']} (decode tile {r.get('decode_launches')}; "
          f"prefill tile {r.get('prefill_tile_launches')}); "
          f"finish {r['finish_reasons']}")
    if r["spec"]:
        sp = r["spec"]
        print(f"      speculation: {sp['accepted']}/{sp['drafted']} drafts accepted "
              f"({100 * sp['acceptance_rate']:.1f}%), {sp['emitted']} tokens over "
              f"{sp['launches']} verify steps ({sp['tokens_per_launch']:.2f} tokens per "
              f"step){', %d draft forwards' % r['forwards'] if 'forwards' in r else ''}")
    if "streams_equal" in r:
        print(f"      streams equal to [{r['plain_is']}]: {r['streams_equal']}/"
              f"{len(r['streams'])}; divergences {r['divergences']}")
    if "streams_equal_f32" in r:
        print(f"      streams equal to the f32-page streams: {r['streams_equal_f32']}/"
              f"{len(r['streams'])} (recorded, not required)")


if __name__ == "__main__":
    sys.exit(main())
