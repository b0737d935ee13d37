"""Serving launcher: continuous batching over the paged KV cache (port of
the `_run_continuous` path of `repro/launch/serve.py`).

Runs on the card unless asked otherwise:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --batch 8 --prompt-len 128 --gen 32 --prefix-cache --prefill-chunk 64
CPU smoke (the plain PyTorch path, no GPU needed):
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --prefix-cache \\
      --prefill-chunk 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --speculate 4 \\
      --draft ngram --prefill-chunk 4 --device cpu   # add --kv-cache int8
--speculate K drafts K tokens per slot and verifies all K+1 in one pass
(greedy-exact); --draft is `ngram` or an arch id for a draft model that
shares the target's vocabulary; --kv-cache int8 stores the pages as int8
with per-row scales.

Flags of the JAX launcher that are not ported yet (--continuous without
--paged, --max-len, --chaos, --abft, --disagg, ...) are rejected.
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

UNPORTED_FLAGS = ("--continuous", "--max-len", "--chaos", "--chaos-seed", "--abft",
                  "--fault-rate", "--disagg", "--disagg-migrate")


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


def _run_continuous(model, cfg, params, args) -> int:
    """2x requests stream through --batch decode slots over the paged KV
    cache; --prefix-cache shares a common system prompt across them."""
    from ..runtime.batcher import ContinuousBatcher

    drafter = make_drafter(cfg, args, param_device(params)) if args.speculate else None
    kv_quant = None
    if args.kv_cache == "int8":
        from ..core.precision import QuantSpec

        kv_quant = QuantSpec("int8", "tile")
    B = args.batch
    max_len = args.prompt_len + args.gen
    # the prefix cache keeps pinned pages resident across requests: size the
    # pool above the dense rectangle so pins don't starve admissions
    num_pages = (B + 2) * -(-max_len // args.page_size) if args.prefix_cache else None
    batcher = ContinuousBatcher(
        model, params, batch_slots=B, max_len=max_len, page_size=args.page_size,
        num_pages=num_pages, kv_quant=kv_quant, prefix_cache=args.prefix_cache,
        prefill_chunk=args.prefill_chunk, speculate=args.speculate, drafter=drafter)
    reqs = make_trace(cfg, 2 * B, args.prompt_len, args.gen, args.prefix_cache)
    t0 = time.perf_counter()
    for r in reqs:
        batcher.submit(r)
    finished = batcher.run_to_completion()
    if batcher.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = sum(len(r.prompt) + len(r.output) for r in finished.values())
    mode = "paged+prefix" if args.prefix_cache else "paged"
    if args.kv_cache == "int8":
        mode += "+int8"
    if args.speculate:
        mode += f"+spec{args.speculate}"
    where = (torch.cuda.get_device_name(batcher.device)
             if batcher.device.type == "cuda" else "CPU")
    print(f"continuous batching [{mode} cache]: {len(finished)} requests "
          f"through {B} slots; {total / wall:.1f} tok/s ({where})")
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
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache (the only cache backend ported)")
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
    if args.speculate:
        args.paged = True  # drafts land in (and roll back over) KV pages
    device = resolve_device(args.device)

    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    model = build_model(cfg)
    if not model.supports_paged():
        raise SystemExit(f"{cfg.name}: only dense attention-only models are "
                         "ported (see ROADMAP.md)")
    if args.speculate and args.draft != "ngram":
        _draft_config(cfg, args)  # refuse a mismatched draft before any weights
    params = model.init(0, device=device)
    return _run_continuous(model, cfg, params, args)


if __name__ == "__main__":
    sys.exit(main())
