"""Serving launcher (port of `repro/launch/serve.py`): static generation
over the dense cache, or continuous batching over the dense or paged cache.

Runs on the card unless asked otherwise:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --batch 8 --prompt-len 128 --gen 32 --prefix-cache --prefill-chunk 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --batch 8 --prompt-len 64 --gen 16       # static, dense cache
CPU smoke (the plain PyTorch path, no GPU needed):
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --prefill-chunk 8 \\
      --device cpu                        # static: chunked prefill + decode
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --smoke \\
      --device cpu                        # Mamba2 hybrid, token-stepped prompt
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --smoke \\
      --continuous --device cpu           # the dense continuous batcher
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m --smoke \\
      --continuous --device cpu           # xLSTM (also internvl2-26b, text only)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-medium \\
      --smoke --device cpu                # encoder-decoder, always static
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --prefix-cache \\
      --prefill-chunk 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch grok-1-314b --smoke \\
      --prefix-cache --prefill-chunk 4 --device cpu   # MoE blocks
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --speculate 4 \\
      --draft ngram --prefill-chunk 4 --device cpu   # add --kv-cache int8
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --abft --paged \\
      --prefill-chunk 4 --device cpu   # checksummed serving
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --prefix-cache \\
      --chaos --fault-rate 0.1 --chaos-seed 0 --device cpu   # fault-injected
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --disagg 2 \\
      --prefill-chunk 4 --device cpu   # add --disagg-migrate, --chaos
As in JAX: without --continuous / --paged (or a flag that implies one) the
launcher generates statically -- a (batch, max_len) bf16 dense cache, the
prompt through chunked prefill where the model supports it
(--prefill-chunk), token stepping otherwise, then greedy decode.  An
encoder-decoder always generates statically, against the encoder output of
32 random frames (x 0.1) per sequence, drawn after the prompt from the same
numpy generator and encoded once.  A prefix-embedding model (internvl2)
serves text only, as JAX's launcher does.
--continuous streams 2x requests through --batch slots of the dense
batcher, --paged through the paged one; --prefix-cache, --speculate and
--disagg imply --paged, --abft and --chaos imply --continuous.
--speculate K drafts K tokens per slot and verifies all K+1 in one pass
(greedy-exact); --draft is
`ngram` or an arch id for a draft model that shares the target's
vocabulary; --kv-cache int8 (with --paged) stores the pages as int8 with
per-row scales; --abft checksums every MX GEMM of the step (on the card:
the ABFT kernels with tile recovery) and the host logits copy.  --chaos
(implies --continuous) threads a seeded `ChaosInjector` through every step
(step failures, one-slot logit poisoning, pool pressure with --paged,
latency spikes, and with --abft bit flips in the audited host copy) with
priorities and deadlines staggered over the trace, and reports the health
record.  --disagg N (implies --paged) serves 4x --batch requests, half of
them sharing a system prompt, through N prefill workers that hand finished
prompts to the decode batcher over one shared page pool, or by page
migration between two pools with --disagg-migrate; with --chaos, worker
kills, hangs and handoff drops too.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..core.device import resolve_device
from ..models import build_model
from ..models.modules import param_device
from .steps import make_chunked_prefill_step, make_serve_step

ENC_FRAMES = 32  # encoder frames per sequence of the static encoder-decoder run


def make_trace(cfg, n_req: int, prompt_len: int, gen: int, prefix_cache: bool):
    """The JAX launcher's request trace: with the prefix cache, a shared
    system prompt of 75% of prompt_len plus per-request tails; without it,
    prompts of random length in [2, prompt_len]."""
    from ..runtime.lifecycle import Request

    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(0, cfg.vocab, max(1, (3 * prompt_len) // 4))
    reqs = []
    for i in range(n_req):
        if prefix_cache:
            tail = rng.integers(0, cfg.vocab, max(1, prompt_len - len(sys_prompt)))
            prompt = np.concatenate([sys_prompt, tail]).astype(np.int32)
        else:
            plen = int(rng.integers(2, prompt_len + 1))
            prompt = rng.integers(0, cfg.vocab, plen).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new=gen))
    return reqs


def make_disagg_trace(cfg, n_req: int, prompt_len: int, gen: int):
    """The JAX launcher's disaggregated trace: even requests share a system
    prompt of 75% of prompt_len plus a tail, odd ones are prompts of random
    length in [2, prompt_len]."""
    from ..runtime.lifecycle import Request

    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(0, cfg.vocab, max(1, (3 * prompt_len) // 4))
    reqs = []
    for i in range(n_req):
        if i % 2 == 0:
            tail = rng.integers(0, cfg.vocab, max(1, prompt_len - len(sys_prompt)))
            prompt = np.concatenate([sys_prompt, tail]).astype(np.int32)
        else:
            plen = int(rng.integers(2, prompt_len + 1))
            prompt = rng.integers(0, cfg.vocab, plen).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new=gen))
    return reqs


def batcher_faults(rate: float, paged: bool, abft: bool) -> dict:
    """The ChaosConfig fault mix of --chaos --fault-rate `rate` over the
    batcher, as JAX's launcher builds it."""
    return dict(step_failure_rate=rate, poison_rate=rate / 4, latency_spike_rate=rate,
                pool_pressure_rate=rate / 2 if paged else 0.0, pool_pressure_pages=2,
                # SDC bit flips only land where the ABFT guard can catch them
                bitflip_rate=rate if abft else 0.0)


def disagg_faults(rate: float) -> dict:
    """The ChaosConfig fault mix of --disagg --chaos --fault-rate `rate`."""
    return dict(step_failure_rate=rate / 4, worker_kill_rate=rate / 8,
                worker_hang_rate=rate / 4, handoff_drop_rate=rate)


def stagger(reqs, prompt_len: int, gen: int) -> None:
    """Under --chaos: priorities alternate and every request gets a generous
    step deadline, so the expiry and preemption paths are visible end to
    end."""
    for i, r in enumerate(reqs):
        r.priority = i % 2
        r.deadline_steps = 8 * (prompt_len + gen)


def _kv_quant(args):
    if args.kv_cache != "int8":
        return None
    from ..core.precision import QuantSpec

    return QuantSpec("int8", "tile")


def _draft_config(cfg, args):
    """The draft model's config for --draft <arch id>: its vocabulary must
    equal the target's."""
    if args.draft not in ARCH_IDS:
        raise SystemExit(f"--draft {args.draft}: 'ngram' or one of {ARCH_IDS}")
    dcfg = get_config(args.draft + ("-smoke" if args.smoke else ""))
    if dcfg.vocab != cfg.vocab:
        raise SystemExit(f"--draft {args.draft}: draft vocab {dcfg.vocab} != "
                         f"target vocab {cfg.vocab}")
    return dcfg


def make_drafter(cfg, args, device):
    """The drafter of --draft: `ngram` (prompt lookup), or a draft model of
    another arch id whose weights come from seed 1."""
    from ..runtime.speculative import DraftModelProposer, NGramDrafter

    if args.draft == "ngram":
        return NGramDrafter()
    dmodel = build_model(_draft_config(cfg, args))
    return DraftModelProposer(dmodel, dmodel.init(1, device=device))


def _where(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"


def _run_static(model, cfg, params, args) -> int:
    """JAX's static generation: --batch prompts of --prompt-len random tokens
    (numpy seed 0) into a (batch, max_len) dense cache of JAX's default
    bf16, prefilled in --prefill-chunk blocks where the model supports it
    and token by token otherwise, then --gen greedy tokens.  An
    encoder-decoder decodes against `model.encode` of ENC_FRAMES frames per
    sequence (standard normals x 0.1 in f32 from the same generator, after
    the prompt), computed once."""
    B = args.batch
    max_len = args.max_len or (args.prompt_len + args.gen)
    device = param_device(params)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (B, args.prompt_len)).astype(np.int32)
    prompt = torch.as_tensor(prompt, device=device).long()
    cache = model.make_cache(B, max_len, device=device)
    step = make_serve_step(model, cfg)
    encdec = cfg.model_kind == "encdec"
    if encdec:
        frames = rng.standard_normal((B, ENC_FRAMES, cfg.frontend_dim)).astype(np.float32)
        enc_out = model.encode(params, torch.as_tensor(frames, device=device) * 0.1)
        serve = step

        def step(p, c, t, i):
            return serve(p, c, t, i, enc_out)

    chunk = args.prefill_chunk
    can_chunk = chunk > 1 and not encdec and model.supports_chunked_prefill()
    if chunk > 1 and not can_chunk:
        print(f"chunked prefill unsupported for {cfg.name}; "
              "falling back to token stepping")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    if can_chunk:
        prefill = make_chunked_prefill_step(model, cfg)
        t = 0
        while t < args.prompt_len:
            c = min(chunk, args.prompt_len - t)
            logits, cache = prefill(params, cache, prompt[:, t:t + c], t)
            t += c
        sync()
        print(f"prefill: {args.prompt_len} tokens in chunks of {chunk}; "
              f"TTFT {(time.perf_counter() - t0) * 1e3:.1f}ms")
    else:
        for t in range(args.prompt_len):
            logits, cache = step(params, cache, prompt[:, t:t + 1], t)
    out_tokens = []
    for t in range(args.prompt_len, args.prompt_len + args.gen):
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        out_tokens.append(tok)
        logits, cache = step(params, cache, tok, t)
    sync()
    wall = time.perf_counter() - t0
    gen = torch.cat(out_tokens, dim=1).cpu().numpy()
    total_tokens = B * (args.prompt_len + args.gen)
    print(f"generated {gen.shape} tokens; "
          f"{total_tokens / wall:.1f} tok/s (batch {B}, {_where(device)})")
    print("sample:", gen[0][:16].tolist())
    return 0


def _run_continuous(model, cfg, params, args) -> int:
    """2x requests stream through --batch decode slots of the dense batcher,
    or the paged one with --paged; --prefix-cache shares a common system
    prompt across them."""
    from ..runtime.batcher import ContinuousBatcher
    from ..runtime.lifecycle import ChaosConfig, ChaosInjector, RetryPolicy

    drafter = make_drafter(cfg, args, param_device(params)) if args.speculate else None
    kv_quant = _kv_quant(args)
    B = args.batch
    max_len = args.max_len or (args.prompt_len + args.gen)
    # the prefix cache keeps pinned pages resident across requests: size the
    # pool above the dense rectangle so pins don't starve admissions
    num_pages = (B + 2) * -(-max_len // args.page_size) if args.prefix_cache else None
    chaos = ChaosInjector(ChaosConfig(
        seed=args.chaos_seed, **batcher_faults(args.fault_rate, args.paged, args.abft))) \
        if args.chaos else None
    batcher = ContinuousBatcher(
        model, params, batch_slots=B, max_len=max_len, paged=args.paged,
        page_size=args.page_size, num_pages=num_pages, kv_quant=kv_quant,
        prefix_cache=args.prefix_cache,
        prefill_chunk=args.prefill_chunk if args.paged else 0,
        chaos=chaos, retry=RetryPolicy(max_retries=3, backoff_s=0.0),
        speculate=args.speculate, drafter=drafter, abft=args.abft)
    reqs = make_trace(cfg, 2 * B, args.prompt_len, args.gen, args.prefix_cache)
    if args.chaos:
        stagger(reqs, args.prompt_len, args.gen)
    t0 = time.perf_counter()
    for r in reqs:
        batcher.submit(r)
    finished = batcher.run_to_completion()
    if batcher.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = sum(len(r.prompt) + len(r.output) for r in finished.values())
    mode = "paged" if args.paged else "dense"
    if args.prefix_cache:
        mode += "+prefix"
    if args.kv_cache == "int8":
        mode += "+int8"
    if args.chaos:
        mode += "+chaos"
    if args.speculate:
        mode += f"+spec{args.speculate}"
    if args.abft:
        mode += "+abft"
    print(f"continuous batching [{mode} cache]: {len(finished)} requests "
          f"through {B} slots; {total / wall:.1f} tok/s ({_where(batcher.device)})")
    if args.paged:
        st = batcher.pool_stats()
        print(f"  pages: {st.pages_in_use} in use / {st.num_pages} pool "
              f"(high water {st.high_water}, page_size {st.page_size}, "
              f"peak utilization {st.high_water / st.num_pages:.2f})")
    if args.speculate:
        sp = batcher.spec_stats()
        print(f"  speculation [k={args.speculate}, draft {args.draft}]: "
              f"{sp['accepted']}/{sp['drafted']} drafts accepted "
              f"({sp['acceptance_rate']:.0%}), "
              f"{sp['emitted']} tokens over {sp['launches']} launches "
              f"({sp['tokens_per_launch']:.2f} tok/launch)")
    if args.prefix_cache:
        ps = batcher.prefix_stats()
        print(f"  prefix cache: {ps['hits']}/{ps['hits'] + ps['misses']} "
              f"admissions hit ({ps['hit_rate']:.0%}), "
              f"{ps['tokens_saved']} prefill tokens skipped, "
              f"{ps['pages_reused']} pages reused now "
              f"(peak shared {ps['shared_high_water']}), "
              f"{ps['cow_copies']} COW copies, "
              f"{ps['evicted_pages']} pages evicted")
    hs = batcher.health_summary()
    if args.abft:
        flips = hs["chaos"]["bitflips_injected"] if args.chaos else 0
        print(f"  abft: {hs['abft']['sdc_detected']} SDC detected / "
              f"{hs['abft']['sdc_corrected']} corrected ({flips} bit flips injected)")
    if args.chaos:
        print(f"  chaos [seed {args.chaos_seed}]: "
              f"{hs['chaos']['failures_injected']} step failures "
              f"({hs['retries']} retries), "
              f"{hs['chaos']['poisons_injected']} poisons "
              f"({hs['quarantined']} quarantined), "
              f"{hs['preemptions']} preemptions / {hs['resumes']} resumes "
              f"(mean resume latency "
              f"{hs['resume_latency_steps_mean']:.1f} steps), "
              f"{hs['stragglers']} straggler steps")
        print("  finish reasons: " + ", ".join(
            f"{k}={v}" for k, v in sorted(hs["finish_reasons"].items())))
        slow = max(batcher.health, key=lambda h: h.dt_s)
        print(f"  health: {hs['steps']} steps recorded; slowest step "
              f"{slow.step} at {slow.dt_s * 1e3:.1f}ms "
              f"(active {slow.active}, queued {slow.queued})")
    for rid in sorted(finished)[:2]:
        print(f"  req {rid}: {finished[rid].output[:8]}")
    return 0


def _run_disagg(model, cfg, params, args) -> int:
    """Disaggregated serving (runtime/disagg.py): --disagg N prefill workers
    fill KV pages and hand finished requests to the decode batcher by
    shipping the page table (shared pool: incref-publish-mount, zero
    copies; --disagg-migrate: disjoint pools with page migration).  --chaos
    adds worker kills, hangs and handoff drops on top of step failures; the
    engine heals by heartbeat detection, page-republish recovery, rerouting
    and degraded-mode decode-side prefill."""
    from ..runtime.disagg import DisaggEngine
    from ..runtime.lifecycle import ChaosConfig, ChaosInjector, RetryPolicy

    B = args.batch
    max_len = args.max_len or (args.prompt_len + args.gen)
    chaos = ChaosInjector(ChaosConfig(seed=args.chaos_seed, **disagg_faults(args.fault_rate))) \
        if args.chaos else None
    eng = DisaggEngine(
        model, params, prefill_workers=args.disagg, batch_slots=B,
        max_len=max_len, page_size=args.page_size,
        prefill_chunk=args.prefill_chunk or 8,
        shared_pool=not args.disagg_migrate, kv_quant=_kv_quant(args),
        chaos=chaos, retry=RetryPolicy(max_retries=3, backoff_s=0.0))
    reqs = make_disagg_trace(cfg, 4 * B, args.prompt_len, args.gen)
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    finished = eng.run_to_completion()
    if eng.batcher.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = sum(len(r.prompt) + len(r.output) for r in finished.values())
    s = eng.summary()
    mode = "shared-pool" if eng.shared_pool else "page-migration"
    if args.chaos:
        mode += "+chaos"
    print(f"disagg serving [{mode}]: {len(finished)} requests, "
          f"{args.disagg} prefill workers -> {B} decode slots; "
          f"{total / wall:.1f} tok/s ({_where(eng.batcher.device)})")
    print(f"  handoffs: {s['handoffs_completed']} completed "
          f"({s['migrated_pages']} pages migrated, "
          f"{s['handoff_drops']} drops, {s['reroutes']} reroutes), "
          f"{s['recoveries']} worker recoveries, "
          f"{s['degraded_forwards']} degraded-mode forwards")
    print("  workers: " + ", ".join(
        f"w{w['wid']}={w['state']}{'(suspected)' if w['suspected'] else ''}"
        f" x{w['launches']}" for w in s["workers"]))
    print("  finish reasons: " + ", ".join(
        f"{k}={v}" for k, v in sorted(s["batcher"]["finish_reasons"].items())))
    if chaos is not None:
        cs = chaos.summary()
        print(f"  chaos [seed {args.chaos_seed}]: "
              f"{cs['worker_kills_injected']} worker kills, "
              f"{cs['worker_hangs_injected']} hangs, "
              f"{cs['handoff_drops_injected']} handoff drops, "
              f"{cs['failures_injected']} step failures")
    for rid in sorted(finished)[:2]:
        print(f"  req {rid}: {finished[rid].output[:8]}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=None,
                    help="cache length per sequence (default prompt-len + gen)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: 2x requests stream through "
                         "--batch decode slots (runtime/batcher.py)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache (implies --continuous): page-pool "
                         "allocator + split-KV flash decode")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share already-prefilled prompt prefixes across "
                         "requests (refcounted shared pages, COW on "
                         "intra-page divergence)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="push each prompt through the cache this many "
                         "tokens per launch (0 = token stepping)")
    ap.add_argument("--kv-cache", choices=("f32", "int8"), default="f32",
                    help="KV page payload: f32, or int8 with per-row f32 "
                         "scale pages (quantized on write)")
    ap.add_argument("--abft", action="store_true",
                    help="checksummed serving: every MX GEMM verifies ABFT "
                         "checksums at its write-back (flagged tiles "
                         "recomputed) and the host logits copy is "
                         "checksummed against the device array "
                         "(kernels/abft, runtime/batcher)")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="speculative decoding (implies --paged): draft K "
                         "tokens per slot per step and verify all K+1 "
                         "positions in one pass; greedy-exact")
    ap.add_argument("--draft", default="ngram",
                    help="drafter under --speculate: 'ngram' (prompt lookup, "
                         "no extra model) or an arch id for a draft model "
                         "sharing the target's vocabulary")
    ap.add_argument("--chaos", action="store_true",
                    help="fault-injected serving (implies --continuous): "
                         "seeded step failures, logit poisoning, pool "
                         "pressure, latency spikes; reports typed finish "
                         "reasons + per-step health (runtime/lifecycle)")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="chaos schedule seed (same seed => same faults)")
    ap.add_argument("--fault-rate", type=float, default=0.1,
                    help="per-step fault probability under --chaos")
    ap.add_argument("--disagg", type=int, default=0, metavar="N",
                    help="disaggregated serving: N prefill workers hand "
                         "finished requests to the decode batcher by "
                         "shipping the page table (runtime/disagg.py)")
    ap.add_argument("--disagg-migrate", action="store_true",
                    help="disjoint prefill/decode pools: handoff migrates "
                         "pages (copy + re-mount) instead of the shared-"
                         "pool metadata handoff")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    if args.speculate < 0:
        ap.error(f"--speculate must be >= 0, got {args.speculate}")
    if args.disagg_migrate and not args.disagg:
        ap.error("--disagg-migrate requires --disagg N")
    if args.chaos:
        args.continuous = True  # chaos lives in the batcher's step loop
    if args.abft:
        args.continuous = True  # the ABFT guard lives in the batcher's step
        if args.disagg:
            ap.error("--abft rides the continuous batcher's step loop; "
                     "combine with --continuous/--paged, not --disagg")
    if args.prefix_cache:
        args.paged = True  # the prefix index lives on the page pool
    if args.disagg:
        args.paged = True  # workers prefill into the page pool
    if args.speculate:
        args.paged = True  # drafts land in (and roll back over) KV pages
        if args.disagg:
            ap.error("--speculate is a decode-loop feature; combine with "
                     "--continuous/--paged, not --disagg")
    if args.kv_cache != "f32" and not args.paged:
        ap.error("--kv-cache int8 requires --paged (the quantized cache "
                 "lives in the page pool)")
    device = resolve_device(args.device)

    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    if cfg.model_kind == "encdec":
        print("enc-dec serving: decoder decode against a fixed encoder memory")
    model = build_model(cfg)
    if args.speculate and args.draft != "ngram":
        _draft_config(cfg, args)  # refuse a mismatched draft before any weights
    params = model.init(0, device=device)
    # the encoder-decoder never goes to the batcher, whatever the flags (JAX)
    if args.disagg and cfg.model_kind != "encdec":
        return _run_disagg(model, cfg, params, args)
    if (args.continuous or args.paged) and cfg.model_kind != "encdec":
        return _run_continuous(model, cfg, params, args)
    return _run_static(model, cfg, params, args)


if __name__ == "__main__":
    sys.exit(main())
