"""Serving launcher (counterpart of `repro.launch.serve`): initializes a
model from a seed and serves a batch of requests through the paged
continuous-batching engine, or with `--legacy` through the fixed-slot
engine (the paged engine's oracle).

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --legacy \\
      --fp8-kv --device cpu

`--ckpt-dir` restores the params from the newest committed checkpoint of a
params tree there (`checkpoint.Checkpointer`), as the reference does.
Without frozen scales the policy's recipe serves at unit scales (the
paper's `PAPER_POLICY`: unfused attention). `--fp8-kv` stores K/V as e5m2.
It runs on the CUDA device unless `--device cpu` asks for the kernels'
plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore the params from the newest committed "
                         "checkpoint of this directory (a checkpoint of the "
                         "params tree), if it holds one")
    ap.add_argument("--legacy", action="store_true",
                    help="use the fixed-slot ServeEngine instead of the "
                         "paged engine")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--fp8-kv", action="store_true")
    ap.add_argument("--n-requests", type=int, default=6)
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV tokens per page")
    ap.add_argument("--n-pages", type=int, default=64,
                    help="pool pages per layer (page 0 is the trash page)")
    ap.add_argument("--chunk-size", type=int, default=32,
                    help="prompt tokens prefilled per request per step")
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 => greedy argmax")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stats", action="store_true",
                    help="print the engine stats() snapshot at the end")
    args = ap.parse_args(argv)

    from repro_torch.models.registry import build_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import (PagedServeConfig, PagedServeEngine,
                                          ServeConfig, ServeEngine)

    cfg = build_config(args.arch, smoke=args.smoke)
    # The engines serve no encoder-decoder; paged serving holds attention
    # stacks only (a recurrent stack is served with --legacy).
    cfg.check_ported(serving=True, paged=not args.legacy)
    if args.fp8_kv:
        cfg = cfg.replace(policy=dataclasses.replace(
            cfg.policy, kv_cache_format="e5m2"))
    params = init_lm(cfg, seed=0, device=args.device)
    if args.ckpt_dir:
        from repro_torch.checkpoint import Checkpointer
        ck = Checkpointer(args.ckpt_dir)
        if ck.latest_step() is not None:
            params, step = ck.restore(params)
            print(f"restored params at step {step}")
    if args.legacy:
        eng = ServeEngine(cfg, params, ServeConfig(
            max_batch=args.max_batch, max_len=args.max_len,
            temperature=args.temperature, seed=args.seed),
            device=args.device)
    else:
        eng = PagedServeEngine(cfg, params, PagedServeConfig(
            max_batch=args.max_batch, max_len=args.max_len,
            n_pages=args.n_pages, page_size=args.page_size,
            chunk_size=args.chunk_size, temperature=args.temperature,
            top_k=args.top_k, top_p=args.top_p, seed=args.seed,
            prefix_cache=not args.no_prefix_cache), device=args.device)
    rng = np.random.default_rng(0)
    pending = [rng.integers(0, cfg.vocab_size, size=rng.integers(4, 12))
               for _ in range(args.n_requests)]
    uid_to_req = {}
    i = 0
    while pending or any(s is not None for s in eng.slots):
        while pending and eng.free_slots():
            uid = eng.add_request(pending.pop(0), max_new_tokens=16)
            uid_to_req[uid] = i
            i += 1
        for uid, toks in eng.step().items():
            print(f"request {uid_to_req[uid]}: generated {toks}")
    print("all requests served")
    if args.stats:
        print(json.dumps(eng.stats(), indent=1))
    return eng


if __name__ == "__main__":
    main()
