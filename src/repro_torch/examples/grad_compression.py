"""FP8 gradient-compression demo on N gloo ranks on the CPU (counterpart of
`examples/grad_compression.py`).

  PYTHONPATH=src python -m repro_torch.examples.grad_compression [--ranks 8]

The data-parallel gradient all-reduce with the gradients quantized to e5m2
on the wire plus error feedback: the paper's storage format turned into a
wire format. Each rank holds its own row of a seeded (N, 4096) gradient;
one compressed mean, then 20 steps of it with the residual fed back, are
held against the true mean. Prints the reference example's lines, and the
bytes `distributed.comm` counted a step.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def _rank(rank: int, world: int, store: str, queue):
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import comm
    from repro_torch.distributed.grad_compress import (compressed_psum_mean,
                                                       wire_bytes_model)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        g_all = (np.random.default_rng(0).standard_normal((world, 4096))
                 * 0.01).astype(np.float32)
        g = {"g": torch.from_numpy(g_all[rank].copy())}
        group = dist.group.WORLD
        true = g_all.mean(0)
        comm.reset_counts()
        red, _ = compressed_psum_mean(g, None, group=group)
        sent = comm.counts()["sent_bytes"]["payload"]
        one_shot = np.linalg.norm(red["g"].numpy() - true) \
            / np.linalg.norm(true)
        acc_t = acc_c = 0.0
        e = None
        for _ in range(20):
            red, e = compressed_psum_mean(g, e, group=group)
            acc_t = acc_t + true
            acc_c = acc_c + red["g"].numpy()
        with_feedback = np.linalg.norm(acc_c - acc_t) / np.linalg.norm(acc_t)
        if rank == 0:
            queue.put((one_shot, with_feedback, sent,
                       wire_bytes_model(g, world)))
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=8)
    args = ap.parse_args(argv)
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank, args=(r, args.ranks, store, queue))
                 for r in range(args.ranks)]
        for p in procs:
            p.start()
        one_shot, with_feedback, sent, model = queue.get(timeout=600)
        for p in procs:
            p.join()
        if any(p.exitcode for p in procs):
            raise RuntimeError("a rank failed")
    print(f"one-shot rel err (pure e5m2 wire): {one_shot:.4f}")
    print(f"20-step accumulated rel err (error feedback): "
          f"{with_feedback:.4f}")
    print("wire bytes per element: 1 (e5m2) vs 2 (bf16) vs 4 (f32)")
    print(f"counted payload bytes a rank a step: {sent:.0f} (the ring model "
          f"{model['bytes_fp8_ef']:.0f}; bf16 {model['bytes_full_bf16']:.0f})")
    assert with_feedback < one_shot
    print("OK: error feedback converges the compressed reduction")


if __name__ == "__main__":
    main()
