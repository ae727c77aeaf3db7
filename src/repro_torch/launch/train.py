"""Training launcher (counterpart of `repro.launch.train`).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
      --steps 3                         # CPU-scale, the plain versions
  PYTHONPATH=src python -m repro_torch.launch.train --microbatches 2
                                        # the card, the CUDA kernels

The reference launcher's flags, plus `--device` (CUDA unless `cpu` is
asked for). It trains the config's own policy, the paper's e5m2 recipe at
unit scales. `build_loop` also takes `recipe="hybrid"` (e4m3 W/A and e5m2
E/G with delayed per-tensor scaling, its site registry discovered from one
forward) and `track_health=True` (the precision-health counters, which
exist only under delayed scaling). Either recipe runs the kernel backend
(`backend="pallas"`, which in the port selects the CUDA kernels), with Adam
and enhanced loss scaling from 2^13. The port runs on one device: the
wire-format flags are accepted and ignored. The config trains without
activation recomputation (remat=False; the reference's launcher keeps the
config's remat=True off `--smoke`, and the port's step runs either way,
bit for bit alike): chip_smoke.py's trainer phase times this path.

`build_loop` makes the TrainLoop that `main` runs; chip_smoke.py drives the
same function.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
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
               log_every: int = 10, device=None):
    """The launcher's TrainLoop: config (`n_layers` cuts its depth),
    recipe, optimizer, data (a callable source, seekable on restore) and,
    under `hybrid`, the DelayedScaling of the discovered site registry.
    `track_health` needs `recipe="hybrid"`."""
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
        checkpoint_every=checkpoint_every or max(10, steps // 4),
        checkpoint_dir=ckpt_dir, log_every=log_every,
        metrics_path=metrics_path or os.path.join(ckpt_dir, "metrics.jsonl"),
        n_microbatches=microbatches)
    return TrainLoop(cfg, opt, data, loop, health=health, scaling=scaling,
                     device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--wire", default="full", choices=["full", "fp8_ef"],
                    help="DP gradient reduction wire format (multi-device "
                         "only; ignored on one device)")
    ap.add_argument("--zero-gather", default="full", choices=["full", "fp8"],
                    help="ZeRO-1 weight all-gather wire format (multi-"
                         "device only; ignored on one device)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    if args.wire != "full" or args.zero_gather != "full":
        print("[train] single device: wire format flags ignored")
    loop = build_loop(arch=args.arch, smoke=args.smoke, steps=args.steps,
                      batch=args.batch, seq=args.seq, lr=args.lr,
                      microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
                      device=args.device)
    loop.install_signal_handlers()
    out = loop.run()
    print(f"finished step {out['last_step']} loss="
          f"{out['metrics'].get('loss', float('nan')):.4f}")
    return out


if __name__ == "__main__":
    main()
