"""The paper's convnet workload: FP8 ResNet training with a constant
loss-scale sweep and RNE against stochastic rounding (its Figs. 2a / 3 /
4 at CIFAR scale; counterpart of the repository's
`examples/resnet_fp8.py`).

    PYTHONPATH=src python -m repro_torch.examples.resnet_fp8 [--device cpu]

Each run trains the reference's reduced ResNet through
`train.convnet.train_convnet` on the kernel backend, so every FP8 conv's
forward GEMM runs the hand-written fp8 GEMM kernel on the card (its plain
PyTorch version with `--device cpu`). `--steps` shortens the runs.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.core.loss_scale import convnet_scaler
from repro_torch.core.precision_policy import (BASELINE, PAPER_FP8,
                                               PAPER_FP8_RNE)
from repro_torch.device import resolve_device
from repro_torch.train.convnet import train_convnet


def _kernels(q):
    return dataclasses.replace(q, backend="pallas")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    kw = dict(steps=args.steps, eval_every=25, device=dev)
    out = {}

    print(f"== paper Fig. 2a: constant loss-scale sweep (FP8 convnet, {dev}) "
          "==")
    for scale in (1.0, 10_000.0):
        h = train_convnet(quant=_kernels(PAPER_FP8),
                          scaler=convnet_scaler(scale), track_underflow=True,
                          **kw)
        out[f"scale={scale:.0f}"] = h
        print(f"  scale={scale:>7.0f}: val_acc={h['val_acc'][-1]:.3f} "
              f"underflow_frac={np.mean(h['underflow_frac']):.4f}")

    print("== paper Fig. 3/4: rounding mode vs generalization ==")
    for name, q in (("fp32", BASELINE), ("fp8+RNE", _kernels(PAPER_FP8_RNE)),
                    ("fp8+SR", _kernels(PAPER_FP8))):
        sc = convnet_scaler(1.0 if name == "fp32" else 10_000.0)
        h = train_convnet(quant=q, scaler=sc, **kw)
        out[name] = h
        print(f"  {name:8s}: val_acc={h['val_acc'][-1]:.3f} "
              f"L2_final={h['l2_loss'][-1]:.4f} "
              f"gap={h['val_nll'][-1] - h['train_nll'][-1]:+.3f}")
    print("OK")
    return out


if __name__ == "__main__":
    main()
