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
As in JAX: without --continuous / --paged (or a flag that implies one) the
launcher generates statically -- a (batch, max_len) bf16 dense cache, the
prompt through chunked prefill where the model supports it
(--prefill-chunk), token stepping otherwise, then greedy decode.  An
encoder-decoder always generates statically, against the encoder output of
32 random frames (x 0.1) per sequence, drawn after the prompt from the same
numpy generator and encoded once.  A prefix-embedding model (internvl2)
serves text only, as JAX's launcher does.
--continuous streams 2x requests through --batch slots of the dense
batcher, --paged through the paged one; --prefix-cache and --speculate
imply --paged, --abft implies --continuous.  --speculate K drafts K tokens
per slot and verifies all K+1 in one pass (greedy-exact); --draft is
`ngram` or an arch id for a draft model that shares the target's
vocabulary; --kv-cache int8 (with --paged) stores the pages as int8 with
per-row scales; --abft checksums every MX GEMM of the step (on the card:
the ABFT kernels with tile recovery) and the host logits copy.

Flags of the JAX launcher that are not ported yet (--chaos, --disagg, ...)
are rejected.
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

UNPORTED_FLAGS = ("--chaos", "--chaos-seed", "--fault-rate", "--disagg",
                  "--disagg-migrate")
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

    drafter = make_drafter(cfg, args, param_device(params)) if args.speculate else None
    kv_quant = None
    if args.kv_cache == "int8":
        from ..core.precision import QuantSpec

        kv_quant = QuantSpec("int8", "tile")
    B = args.batch
    max_len = args.max_len or (args.prompt_len + args.gen)
    # the prefix cache keeps pinned pages resident across requests: size the
    # pool above the dense rectangle so pins don't starve admissions
    num_pages = (B + 2) * -(-max_len // args.page_size) if args.prefix_cache else None
    batcher = ContinuousBatcher(
        model, params, batch_slots=B, max_len=max_len, paged=args.paged,
        page_size=args.page_size, num_pages=num_pages, kv_quant=kv_quant,
        prefix_cache=args.prefix_cache,
        prefill_chunk=args.prefill_chunk if args.paged else 0,
        speculate=args.speculate, drafter=drafter, abft=args.abft)
    reqs = make_trace(cfg, 2 * B, args.prompt_len, args.gen, args.prefix_cache)
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
    if args.abft:
        hs = batcher.health_summary()
        print(f"  abft: {hs['abft']['sdc_detected']} SDC detected / "
              f"{hs['abft']['sdc_corrected']} corrected (0 bit flips injected)")
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
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args, unknown = ap.parse_known_args(argv)
    unported = [a for a in unknown if a.split("=")[0] in UNPORTED_FLAGS]
    if unported:
        ap.error(f"not ported yet: {' '.join(unported)} "
                 "(see ROADMAP.md, queue 1)")
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    if args.speculate < 0:
        ap.error(f"--speculate must be >= 0, got {args.speculate}")
    if args.abft:
        args.continuous = True  # the ABFT guard lives in the batcher's step
    if args.prefix_cache:
        args.paged = True  # the prefix index lives on the page pool
    if args.speculate:
        args.paged = True  # drafts land in (and roll back over) KV pages
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
    if (args.continuous or args.paged) and cfg.model_kind != "encdec":
        return _run_continuous(model, cfg, params, args)
    return _run_static(model, cfg, params, args)


if __name__ == "__main__":
    sys.exit(main())
