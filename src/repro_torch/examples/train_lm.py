"""End-to-end training example (counterpart of the repository's
`examples/train_lm.py`): an LM trained by the production loop, with the
FP8 recipe, enhanced loss scaling, checkpoint/restart, preemption handling,
straggler detection and the metrics jsonl.

  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 30 \\
      --small --device cpu

The default config is a ~100M-parameter qwen2-family model (d 512, 12
layers, vocab 32k); `--small` a CI-scale one. The paper's recipe runs on
the kernel backend (`backend="pallas"`: the CUDA kernels on the card, the
plain versions on the CPU); `--baseline` trains the 16/32-bit baseline
instead. Kill the process with SIGTERM and run it again to watch the
checkpoint/restart resume where it stopped. It runs on the CUDA device
unless `--device cpu` asks for the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.core.loss_scale import LossScaler
from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
from repro_torch.models.registry import build_config
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.step import make_optimizer_for


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--baseline", action="store_true",
                    help="FP32/BF16 baseline instead of FP8")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    if args.small:
        cfg = build_config(args.arch, smoke=True).replace(
            n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
            vocab_size=512, remat=False)
        batch, seq = 8, 64
    else:
        # ~100M params: 12L x d512 x ff2048, 32k vocab; each layer
        # recomputed in the backward (remat, the config's default).
        cfg = build_config(args.arch, smoke=True).replace(
            n_layers=12, d_model=512, n_heads=8, n_kv_heads=2, d_ff=2048,
            vocab_size=32768, max_seq_len=512)
        batch, seq = 8, 256
    if args.baseline:
        from repro_torch.core.precision_policy import BASELINE_POLICY
        cfg = cfg.replace(policy=BASELINE_POLICY)
    else:
        cfg = cfg.replace(policy=dataclasses.replace(
            cfg.policy, quant=dataclasses.replace(cfg.policy.quant,
                                                  backend="pallas")))
    print(f"training {cfg.arch}-family model, ~{cfg.param_count():,} params, "
          f"fp8={'off' if args.baseline else 'on'}")

    opt = make_optimizer_for(cfg, name="adam", learning_rate=1e-3,
                             scaler=LossScaler(mode="enhanced",
                                               init_scale=2.0**13,
                                               min_scale_schedule=(
                                                   (100, 64.0),)))
    data = synthetic_lm_batches(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=seq, batch_size=batch,
                                           seed=0))
    loop = TrainLoop(cfg, opt, data,
                     LoopConfig(total_steps=args.steps, checkpoint_every=50,
                                checkpoint_dir=args.ckpt, log_every=10,
                                metrics_path=f"{args.ckpt}/metrics.jsonl"),
                     seed=0, device=args.device)
    loop.install_signal_handlers()
    out = loop.run()
    print(f"done at step {out['last_step']}: loss="
          f"{out['metrics'].get('loss'):.4f} "
          f"(stragglers={out['stragglers']})")
    return out


if __name__ == "__main__":
    main()
