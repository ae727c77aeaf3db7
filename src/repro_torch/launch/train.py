"""Training launcher (counterpart of `repro.launch.train`).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
      --steps 3                         # CPU-scale, the plain versions
  PYTHONPATH=src python -m repro_torch.launch.train --microbatches 2
                                        # the card, the CUDA kernels
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc_per_node 2 -m repro_torch.launch.train --device cpu \\
      --backend gloo --smoke --wire fp8_ef --steps 3
                                        # data parallel, e5m2 on the wire

The reference launcher's flags, plus `--device` (CUDA unless `cpu` is
asked for), `--backend`, `--recipe`, `--track-health`, `--n-layers`,
`--log-every` and `--report`. It trains the config's own policy, the
paper's e5m2 recipe at unit scales, or with `--recipe hybrid` e4m3 W/A and
e5m2 E/G with delayed per-tensor scaling (its site registry discovered
from one forward; `--track-health` adds the precision-health counters,
which exist only under delayed scaling). Either recipe runs the kernel
backend (`backend="pallas"`, which in the port selects the CUDA kernels),
with Adam and enhanced loss scaling from 2^13. The config trains without
activation recomputation (remat=False; the reference's launcher keeps the
config's remat=True off `--smoke`, and the port's step runs either way,
bit for bit alike): chip_smoke.py's trainer phase times this path.

Data parallelism: under `torch.distributed.run` the launcher reads
`RANK`, `WORLD_SIZE` and `LOCAL_RANK`; with more than one process it joins
the process group (`--backend`: NCCL by default on the card, gloo with
`--device cpu`; each rank on card `LOCAL_RANK` modulo the cards there) and
builds a `ParallelPlan` over a flat `('data',)` DeviceMesh from
`--wire` / `--zero-gather`, as the reference builds one when it sees more
than one device: from the config's `policy.dist` with its wire formats
replaced, so ZeRO-1 is on (`DistConfig.zero1`'s default, as in the
reference): each rank keeps its shards of the master weights and the Adam
moments, and `--zero-gather fp8` moves the weight all-gather as e4m3
payloads under `--wire fp8_ef` (under `--wire full` the reference never
calls its fp8 gather, so there it trains as `--zero-gather full` does).
`build_plan(zero1=False)` turns ZeRO-1 off. `--batch` is the global batch;
each rank trains its slice. On one process the wire flags are ignored.

`--report DIR` writes `DIR/rank<r>.json` per rank after the run: the
step records, digests of the final master weights, Adam moments and
loss-scale state (under ZeRO-1 of the state gathered whole, so equal
digests still mean the replicas agree), of ScaleState and of the
residual, the master leaves' whole sizes, the peak device memory, the
kernels' launch counts over the run (set to 0 just before it) and what
`distributed.comm` counted.

`build_loop` makes the TrainLoop that `main` runs; chip_smoke.py drives the
same function.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Optional

import numpy as np

DEFAULT_CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def build_loop(*, arch: str = "qwen2-1.5b", smoke: bool = False,
               n_layers: Optional[int] = None, steps: int = 100,
               batch: int = 8, seq: int = 128, lr: float = 1e-3,
               microbatches: int = 1, recipe: str = "paper",
               track_health: bool = False, ckpt_dir: str = DEFAULT_CKPT,
               checkpoint_every: Optional[int] = None,
               metrics_path: Optional[str] = None, health=None,
               log_every: int = 10, plan=None, device=None):
    """The launcher's TrainLoop: config (`n_layers` cuts its depth),
    recipe, optimizer, data (a callable source of global batches of
    `batch` rows, seekable on restore) and, under `hybrid`, the
    DelayedScaling of the discovered site registry. `track_health` needs
    `recipe="hybrid"`. `plan`: a data-parallel ParallelPlan (its wire
    format becomes the config's `policy.dist`)."""
    from repro_torch.core.loss_scale import LossScaler
    from repro_torch.core.precision_policy import QuantConfig
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
    from repro_torch.device import resolve_device
    from repro_torch.models.registry import build_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.scaling.calibrate import discover_lm_sites
    from repro_torch.scaling.state import DelayedScaling
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.step import make_optimizer_for

    if track_health and recipe != "hybrid":
        raise ValueError("track_health counts under delayed scaling: it "
                         "needs recipe='hybrid'")
    dev = resolve_device(device)
    cfg = build_config(arch, smoke=smoke).replace(remat=False)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    if recipe == "paper":
        quant = dataclasses.replace(cfg.policy.quant, backend="pallas")
    elif recipe == "hybrid":
        quant = QuantConfig(recipe="hybrid", scaling="delayed",
                            backend="pallas", track_health=track_health)
    else:
        raise ValueError(f"unknown recipe {recipe!r} (paper, hybrid)")
    cfg = cfg.replace(policy=dataclasses.replace(cfg.policy, quant=quant))
    if plan is not None:
        cfg = cfg.replace(policy=dataclasses.replace(cfg.policy,
                                                     dist=plan.dist))
    scaling = None
    if quant.delayed:
        rows = min(seq, 128)
        probe = {"tokens": np.zeros((1, rows), np.int32),
                 "labels": np.zeros((1, rows), np.int32)}
        registry = discover_lm_sites(cfg, init_lm(cfg, device=dev), probe)
        scaling = DelayedScaling(registry, qcfg=quant)
    opt = make_optimizer_for(cfg, name="adam", learning_rate=lr,
                             scaler=LossScaler(mode="enhanced",
                                               init_scale=2.0 ** 13))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          batch_size=batch, seed=0)

    def data(start_step: int):
        return synthetic_lm_batches(data_cfg, start_step=start_step)

    loop = LoopConfig(
        total_steps=steps,
        checkpoint_every=(max(10, steps // 4) if checkpoint_every is None
                          else checkpoint_every),
        checkpoint_dir=ckpt_dir, log_every=log_every,
        metrics_path=metrics_path or os.path.join(ckpt_dir, "metrics.jsonl"),
        n_microbatches=microbatches)
    return TrainLoop(cfg, opt, data, loop, health=health, scaling=scaling,
                     plan=plan, device=dev)


def dist_env():
    """(rank, world size, local rank) from torch.distributed.run's
    environment; (0, 1, 0) without it."""
    env = os.environ
    return (int(env.get("RANK", 0)), int(env.get("WORLD_SIZE", 1)),
            int(env.get("LOCAL_RANK", 0)))


def build_plan(world: int, backend: str, device, wire: str = "full",
               zero_gather: str = "full", zero1: Optional[bool] = None):
    """Joins the process group (if this process has not) and returns the
    launcher's data-parallel plan over a flat ('data',) mesh of `world`
    ranks: `DistConfig()` (the configs' policy.dist) with its wire formats
    replaced, ZeRO-1 on unless `zero1=False`."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.precision_policy import DistConfig
    from repro_torch.distributed.strategy import ParallelPlan
    if not dist.is_initialized():
        dist.init_process_group(backend)
    # The mesh's device type only names where DTensors would live; a gloo
    # mesh over ranks that share a card is a host mesh.
    mesh_dev = "cuda" if backend == "nccl" else "cpu"
    mesh = DeviceMesh(mesh_dev, torch.arange(world),
                      mesh_dim_names=("data",))
    dist_cfg = dataclasses.replace(DistConfig(), wire=wire,
                                   wire_zero_gather=zero_gather)
    if zero1 is not None:
        dist_cfg = dataclasses.replace(dist_cfg, zero1=zero1)
    return ParallelPlan.build(mesh, dist_cfg)


_WORDS = {4: "int32", 2: "int16", 1: "uint8"}


def _word_sum(words, index):
    """sum_i w_i (2 h(i) + 1) mod 2^64 (an int64 tensor) over words w_i at
    positions `index` (int64 tensors of one shape), h a multiplicative
    hash of the position."""
    import torch
    h = (index * 0x9E3779B1 + 0x7F4A7C15) & 0xFFFFFFFF
    return (words.to(torch.int64) * (2 * h + 1)).sum()


def _words(t, nbytes: int):
    """The word size of a tensor of `nbytes` bytes (4, 2 or 1: the largest
    that divides them) and its torch dtype."""
    import torch
    size = next(k for k in (4, 2, 1) if nbytes % k == 0)
    return size, getattr(torch, _WORDS[size])


def _checksum(t) -> int:
    """A 64-bit positional checksum of a tensor's bytes, computed where it
    lives: sum_i w_i (2 h(i) + 1) mod 2^64 over its words w_i (4, 2 or 1
    bytes), h a multiplicative hash of the position. Changing any one bit
    changes it."""
    import torch
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    _, dtype = _words(t, flat.numel())
    words = flat.view(dtype)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    chunk = 1 << 26
    for lo in range(0, words.numel(), chunk):
        w = words[lo:lo + chunk]
        total = total + _word_sum(w, torch.arange(
            lo, lo + w.numel(), dtype=torch.int64, device=t.device))
    return int(total)


def _shard_checksum(shard, dim: int, plan):
    """The whole leaf's `_checksum` from ZeRO-1 shards without gathering
    them: this rank's words at their positions in the whole leaf, summed
    over 'data' (wrapping mod 2^64, as the whole sum does). The shard is
    chunk r of N along `dim`, so each of its rows over the dims before
    `dim` is one run of the whole's bytes. None where a run does not fill
    whole words (the caller gathers that leaf)."""
    import torch

    from repro_torch.distributed import comm
    n, r = plan.zero_size, plan.zero_rank
    es = shard.element_size()
    shape = list(shard.shape)
    outer = int(np.prod(shape[:dim], dtype=np.int64))
    inner = int(np.prod(shape[dim + 1:], dtype=np.int64))
    run = shape[dim] * inner * es              # a row's bytes in the shard
    size, dtype = _words(shard, shard.numel() * es * n)
    if run % size:
        return None
    per, stride = run // size, run * n // size
    rows = shard.detach().contiguous().reshape(-1).view(torch.uint8) \
        .reshape(outer, run).view(dtype)
    total = torch.zeros((), dtype=torch.int64, device=shard.device)
    step = max(1, (1 << 26) // max(per, 1))
    for lo in range(0, outer, step):
        w = rows[lo:lo + step]
        o = torch.arange(lo, lo + w.shape[0], dtype=torch.int64,
                         device=shard.device)
        j = torch.arange(per, dtype=torch.int64, device=shard.device)
        total = total + _word_sum(w, o[:, None] * stride + r * per + j)
    return int(comm.all_reduce(total.reshape(1), "sum",
                               plan.zero_group())[0])


def state_digest(tree, plan=None, dims=None) -> str:
    """sha256 over each tensor / array leaf of a (nested dict / dataclass)
    tree, in path order: its path, dtype, shape and 64-bit checksum of its
    bytes (`_checksum`, on the leaf's device: no copy to the host). With a
    ZeRO-1 `plan` and `dims` (a dict tree over the same top-level paths,
    each leaf a ZeRO dim or None, a None subtree for parts kept whole),
    the leaves of `tree` that are this rank's shards are digested as the
    whole leaves they are chunks of (shape and checksum summed over the
    ranks, `_shard_checksum`), so every rank writes the digest of the
    state gathered whole without gathering it; every rank must call it."""
    import hashlib

    import torch

    from repro_torch.checkpoint.checkpointer import _flatten
    h = hashlib.sha256()
    for key, leaf in sorted(_flatten(tree).items()):
        t = leaf if isinstance(leaf, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(leaf))
        d = _dim_at(dims, key)
        shape, total = tuple(t.shape), None
        if d is not None:
            shape = tuple(s * plan.zero_size if i == d else s
                          for i, s in enumerate(shape))
            total = _shard_checksum(t, d, plan)
            if total is None:
                t = _gather_leaf(t, d, plan)
        if total is None:
            total = _checksum(t)
        h.update(f"{key}|{t.dtype}|{shape}|{total}".encode())
    return h.hexdigest()


def _dim_at(dims, key: str):
    """The ZeRO dim of the leaf at `key` (a '/'-joined path) in `dims`."""
    for part in key.split("/"):
        if not isinstance(dims, dict):
            return None
        dims = dims.get(part)
    return dims if isinstance(dims, int) else None


def _gather_leaf(t, dim: int, plan):
    from repro_torch.distributed import comm
    from repro_torch.models.convert import unshard_leaves
    return unshard_leaves(list(comm.all_gather(t, plan.zero_group())), dim)


def reset_kernel_launches():
    from repro_torch.kernels.fp8_attention import ops as at
    from repro_torch.kernels.fp8_matmul import ops as mm
    from repro_torch.kernels.fused_quant_matmul import ops as fq
    from repro_torch.kernels.stochastic_round import ops as sr
    for mod in (fq, at, mm, sr):
        mod.reset_launches()


def kernel_launches():
    """The CUDA kernels' launch counters (each wrapper's, since its last
    reset)."""
    from repro_torch.kernels.fp8_attention import ops as at
    from repro_torch.kernels.fp8_matmul import ops as mm
    from repro_torch.kernels.fused_quant_matmul import ops as fq
    from repro_torch.kernels.stochastic_round import ops as sr
    out = {f"fused_quant_matmul.{d}": n
           for d, n in fq.fused_quant_matmul.launches_by_dims.items()}
    out.update(fp8_attention_fwd=at.fp8_attention_fwd.launches,
               fp8_attention_fwd_counts=(
                   at.fp8_attention_fwd.launches_with_counts),
               fp8_attention_bwd_dq=at.fp8_attention_bwd_dq.launches,
               fp8_attention_bwd_dq_counts=(
                   at.fp8_attention_bwd_dq.launches_with_counts),
               fp8_attention_bwd_dkv=at.fp8_attention_bwd_dkv.launches,
               fp8_matmul=mm.fp8_matmul.launches,
               sr_quantize=sr.sr_quantize.launches,
               sr_quantize_onchip=sr.sr_quantize_onchip.launches)
    return out


def write_report(path: str, rank: int, world: int, loop, out, records):
    """The run's report for this rank (module docstring)."""
    import json

    import torch

    from repro_torch.distributed import comm
    from repro_torch.obs.metrics import jsonable
    from repro_torch.optim.optimizers import tmap
    state = out["state"]
    dev = state.loss_scale.scale.device
    plan, dims = loop.plan, None
    if plan is not None and plan.zero1 is not None:
        d = plan.zero_dims()
        dims = {"master": d, "opt_state": {"mu": d, "nu": d}}
    shapes = plan.full_shapes(state.master) if plan is not None \
        else tmap(lambda x: tuple(x.shape), state.master)
    err = out.get("wire_error")
    err_max = max((float(e.abs().max()) for e in _leaves(err)),
                  default=0.0) if err is not None else None
    dev = state.loss_scale.scale.device
    report = {
        "rank": rank, "world_size": world,
        "plan": loop.plan.describe() if loop.plan is not None else None,
        "last_step": out["last_step"],
        "records": [{k: jsonable(v) for k, v in r.items()
                     if not k.startswith("health/")} for r in records],
        "state_digest": state_digest(
            {"master": state.master, "opt_state": state.opt_state,
             "loss_scale": state.loss_scale}, plan, dims),
        "scale_state_digest": (state_digest(out["scale_state"])
                               if out["scale_state"] is not None else None),
        "wire_error_digest": (state_digest(err) if err is not None
                              else None),
        "wire_error_absmax": err_max,
        "leaf_numels": [int(np.prod(x)) for x in _leaves(shapes)],
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
        "launches": kernel_launches(),
        "comm": comm.counts(),
    }
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch (each data-parallel rank trains "
                         "its slice)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the config's depth")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT)
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="steps between checkpoints (default max(10, "
                         "steps // 4)); 0: no checkpoints")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--recipe", default="paper", choices=["paper", "hybrid"])
    ap.add_argument("--track-health", action="store_true",
                    help="precision-health counters (needs --recipe "
                         "hybrid)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--wire", default="full", choices=["full", "fp8_ef"],
                    help="DP gradient reduction wire format "
                         "(policy.dist.wire): fp8_ef = e5m2 all-reduce "
                         "with error feedback (more than one process)")
    ap.add_argument("--zero-gather", default="full", choices=["full", "fp8"],
                    help="ZeRO-1 weight all-gather wire format (more than "
                         "one process; fp8 = e4m3 payloads under --wire "
                         "fp8_ef, inert under --wire full as in the "
                         "reference)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend (more than one process): "
                         "nccl by default on the card, gloo on the CPU")
    ap.add_argument("--report", default=None,
                    help="directory for each rank's rank<r>.json report")
    args = ap.parse_args(argv)
    rank, world, local_rank = dist_env()
    device = args.device
    plan = None
    if world > 1:
        import torch
        backend = args.backend or ("gloo" if device == "cpu" else "nccl")
        if device is None or device == "cuda":
            device = f"cuda:{local_rank % max(1, torch.cuda.device_count())}"
            if torch.cuda.is_available():
                torch.cuda.set_device(torch.device(device))
        plan = build_plan(world, backend, device, args.wire,
                          args.zero_gather)
        if rank == 0:
            print(f"[train] parallel plan ({world} ranks, {backend}): "
                  f"{plan.describe()}")
    elif args.wire != "full" or args.zero_gather != "full":
        print("[train] single device: wire format flags ignored")
    t0 = time.perf_counter()
    loop = build_loop(arch=args.arch, smoke=args.smoke,
                      n_layers=args.n_layers, steps=args.steps,
                      batch=args.batch, seq=args.seq, lr=args.lr,
                      microbatches=args.microbatches, recipe=args.recipe,
                      track_health=args.track_health, ckpt_dir=args.ckpt_dir,
                      checkpoint_every=args.checkpoint_every,
                      log_every=args.log_every, plan=plan, device=device)
    if rank == 0:
        print(f"[train] built the loop in {time.perf_counter() - t0:.1f} s")
    records = []
    loop.on_metrics = lambda step, rec: records.append(rec)
    loop.install_signal_handlers()
    if args.report:
        # The report's launch counts are those of the run alone (not of
        # the site discovery's forward).
        reset_kernel_launches()
    out = loop.run()
    if args.report:
        t0 = time.perf_counter()
        write_report(args.report, rank, world, loop, out, records)
        if rank == 0:
            print(f"[train] wrote the report in "
                  f"{time.perf_counter() - t0:.1f} s")
    print(f"finished step {out['last_step']} loss="
          f"{out['metrics'].get('loss', float('nan')):.4f}"
          + (f" (rank {rank} of {world})" if world > 1 else ""))
    return out


if __name__ == "__main__":
    main()
