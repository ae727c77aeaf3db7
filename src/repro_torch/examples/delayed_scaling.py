"""Delayed per-tensor scaling end to end: train -> calibrate -> freeze ->
serve (counterpart of the repository's `examples/delayed_scaling.py`).

    PYTHONPATH=src python -m repro_torch.examples.delayed_scaling [--device cpu]

The hybrid recipe (e4m3 W/A, e5m2 E/G) with per-site scales from the amax
history, on the kernel backend's fused path (the reference example's
"xla" backend runs the same recipe on its unfused path, which the port
also runs: `QuantConfig(backend="xla")`, or `fuse_epilogue=False,
fuse_attention=False` on the kernel backend for kernel 5):
 1. the site registry from one forward of the loss,
 2. ten delayed-scaling training steps,
 3. calibration on held-out batches, the e5m2 KV cache's sites included,
    and a freeze that records the format each scale was calibrated under,
 4. deterministic FP8 serving from the frozen scales with an e5m2 KV cache
    through the fixed-slot engine, which checks those formats.
It runs on the CUDA device unless `--device cpu` asks for the kernels'
plain versions.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.precision_policy import PrecisionPolicy, QuantConfig
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_lm
from repro_torch.scaling.calibrate import (calibrate, discover_lm_sites,
                                           freeze_with_formats)
from repro_torch.scaling.state import DelayedScaling
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.train.step import make_optimizer_for, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    quant = QuantConfig(recipe="hybrid", scaling="delayed", backend="pallas")
    print("precision recipe:", quant.recipe_table())
    policy = PrecisionPolicy(quant=quant, kv_cache_format="e5m2")
    cfg = ModelConfig(arch="demo", n_layers=2, d_model=64, n_heads=2,
                      n_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64,
                      policy=policy, remat=False)
    params = init_lm(cfg, seed=0, device=dev)

    # 1. The site registry (W/A/E/G and the KV cache's).
    b, s = 2, 16
    rng = np.random.default_rng(0)
    proto = {"tokens": np.zeros((b, s), np.int32),
             "labels": np.zeros((b, s), np.int32)}
    registry = discover_lm_sites(cfg, params, proto)
    print(f"{len(registry)} scale sites, e.g. {registry.keys[0]}")

    # 2. Delayed-scaling training: the ScaleState is updated every step.
    ds = DelayedScaling(registry, qcfg=quant)
    opt = make_optimizer_for(cfg, learning_rate=1e-3)
    step = make_train_step(cfg, opt, scaling=ds, device=dev)
    state, scale_state = opt.init(params), ds.init()
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(10):
        toks = rng.integers(0, 256, (b, s))
        (state, scale_state), m = step(state, scale_state,
                                       {"tokens": toks, "labels": toks}, gen)
    print(f"trained 10 steps, loss={m['loss']:.3f}, "
          f"{int((scale_state.scale != 1.0).sum())} scales live")

    # 3. Calibrate on held-out batches and freeze the scales with the
    #    formats they were calibrated under (e4m3 for W/A, e5m2 for the
    #    KV cache).
    trained = opt.compute_params(state)
    calib = [{"tokens": rng.integers(0, 256, (b, s))} for _ in range(4)]
    ds2, cal_state = calibrate(trained, cfg, calib)
    frozen, formats = freeze_with_formats(ds2, cal_state, cfg)
    kv = [k for k in frozen if "/kv/" in k]
    counts = {f: sum(v == f for v in formats.values())
              for f in sorted(set(formats.values()))}
    print(f"frozen {len(frozen)} scales ({len(kv)} KV-cache sites), "
          f"formats: {counts}")

    # 4. Deterministic calibrated serving; the engine refuses a site its
    #    config would quantize in another format than it was calibrated in.
    eng = ServeEngine(cfg, trained, ServeConfig(max_batch=2, max_len=48),
                      frozen_scales=frozen, frozen_formats=formats,
                      device=dev)
    uid = eng.add_request(np.array([1, 2, 3], np.int32), max_new_tokens=8)
    out = eng.run_to_completion()
    print("generated:", out[uid])
    return out[uid]


if __name__ == "__main__":
    main()
