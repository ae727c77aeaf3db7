"""Quickstart: train a small LM with the paper's FP8 recipe through the
port's kernels (counterpart of the repository's `examples/quickstart.py`).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The reference quickstart's model, data, 60 steps and recipe: `PAPER_POLICY`
(e5m2 for weights, activations, errors and gradients at unit scales, RNE
for weights and stochastic rounding for the rest), enhanced loss scaling,
fp16 master weights and Adam. The one change is `backend="pallas"`, so
that every forward projection GEMM runs the hand-written fp8 GEMM kernel;
the reference's "xla" and "pallas" backends compute the same numbers
there. It runs on the CUDA device unless `--device cpu` asks for the
kernels' plain PyTorch versions.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core.loss_scale import LossScaler
from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_config
from repro_torch.models.transformer import init_lm
from repro_torch.train.step import make_optimizer_for, make_train_step

VOCAB = 256
STEPS = 60


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. The reference quickstart's model and recipe, on the kernel backend.
    cfg = build_config("qwen2-1.5b", smoke=True).replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=VOCAB, remat=False)
    quant = dataclasses.replace(cfg.policy.quant, backend="pallas")
    cfg = cfg.replace(policy=dataclasses.replace(cfg.policy, quant=quant))
    print(f"arch={cfg.arch} on {dev}  FP8 recipe: {quant.fwd_format} fwd / "
          f"{quant.bwd_format} bwd, scaling={quant.scaling}, "
          f"master={cfg.policy.master_weight_dtype}")

    # 2. Mixed-precision optimizer with the paper's enhanced loss scaling.
    opt = make_optimizer_for(cfg, name="adam", learning_rate=3e-3,
                             scaler=LossScaler(mode="enhanced",
                                               init_scale=1024.0,
                                               min_scale_schedule=()))
    step = make_train_step(cfg, opt, device=dev)

    # 3. Deterministic synthetic data with learnable bigram structure.
    data = synthetic_lm_batches(DataConfig(vocab_size=VOCAB, seq_len=64,
                                           batch_size=16, seed=0))
    state = opt.init(init_lm(cfg, seed=0, device=dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    print(f"unigram entropy (no learning) = {np.log(VOCAB):.3f} nats")
    for i in range(STEPS):
        state, m = step(state, next(data), gen)
        if i % 10 == 0 or i == STEPS - 1:
            print(f"step {i:3d}  loss={m['loss']:.4f}  "
                  f"scale={m['loss_scale']:.0f}  "
                  f"finite={m['grads_finite']}")
    if not m["loss"] < np.log(VOCAB):
        raise SystemExit("FP8 training failed to learn")
    print("OK: FP8 training learned the synthetic structure.")
    return m["loss"]


if __name__ == "__main__":
    main()
