"""Batched serving: the paged engine against the fixed-slot engine
(counterpart of the repository's `examples/serve_batched.py`).

    PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]

Eight requests stream through the paged engine (chunked prefill and
decode in one fixed-shape step, KV in a shared page pool, sampling on the
device, repeated prompts hitting the exact prefix cache). The same
workload then runs through the fixed-slot engine, whose token streams
must be identical, and once more with temperature sampling. The model is
the reference example's, under `PAPER_POLICY` at unit scales (unfused
attention). It runs on the CUDA device unless `--device cpu` asks for the
kernels' plain versions.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.models.registry import build_config
from repro_torch.models.transformer import init_lm
from repro_torch.serve.engine import (PagedServeConfig, PagedServeEngine,
                                      ServeConfig, ServeEngine)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    cfg = build_config("qwen2-1.5b", smoke=True).replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512)
    params = init_lm(cfg, seed=0, device=args.device)

    # Request 7 repeats request 0's prompt (longer than one 8-token page):
    # an exact prefix-cache hit reuses request 0's full prompt pages.
    prompts = [np.arange(9 + i) % cfg.vocab_size for i in range(7)]
    prompts.append(prompts[0].copy())

    def run(engine):
        outs, order = {}, {}
        pending = list(enumerate(prompts))
        while pending or any(s is not None for s in engine.slots):
            while pending and engine.free_slots():
                i, p = pending.pop(0)
                order[engine.add_request(p, max_new_tokens=8)] = i
            for uid, toks in engine.step().items():
                outs[order[uid]] = toks
        return outs

    print("paged engine (chunked prefill, page pool, on-device sampling):")
    paged = PagedServeEngine(cfg, params, PagedServeConfig(
        max_batch=4, max_len=64, n_pages=32, page_size=8, chunk_size=8),
        device=args.device)
    got = run(paged)
    for i in sorted(got):
        print(f"  request {i} done: {got[i]}")
    s = paged.stats()
    print(f"  page occupancy now {s['page_occupancy']:.2f}, prefix-cache "
          f"hit rate {s['prefix_cache_hit_rate']:.2f}")

    print("fixed-slot engine (the paged engine's oracle):")
    ref = run(ServeEngine(cfg, params, ServeConfig(max_batch=4, max_len=64),
                          device=args.device))
    if any(got[i] != ref[i] for i in ref):
        raise SystemExit(f"streams diverged: paged {got}, fixed-slot {ref}")
    print("  all 8 token streams identical to the paged engine's")

    print("temperature sampling (on the device, per-request generators):")
    sampled = PagedServeEngine(cfg, params, PagedServeConfig(
        max_batch=4, max_len=64, n_pages=32, page_size=8, chunk_size=8,
        temperature=0.8, top_p=0.95, seed=7), device=args.device)
    for i, toks in sorted(run(sampled).items()):
        print(f"  request {i} sampled: {toks}")
    print("OK")
    return got


if __name__ == "__main__":
    main()
