"""Calibration + freeze: from amax history to deterministic FP8 serving
(counterpart of `repro.scaling.calibrate`).

`calibrate` runs the forward (mode 'train', RNE, saturating, delayed
scaling) over N batches: scales start at 1.0 and follow the amax history
exactly as the reference's DelayedScaling does. The first batch also
registers every site it touches (the reference discovers them by an
abstract trace, which eager PyTorch has no counterpart of; its first batch
runs at unit scales either way). `freeze` emits {site_key: float};
`save_frozen` / `load_frozen` / `load_frozen_formats` keep it in the
reference's JSON file under the reference's keys for the config, whose
remainder layers sit under `rem_{i}` and scanned stacks under `stack_{p}`
(`reference_keys`, `port_keys`), so either package reads a file the other
wrote. An encoder-decoder's
batches also hold "enc_inputs": `encode` runs before the decoder, so the
encoder's and the cross-attention's sites are observed too, as in the
reference.

With an FP8 KV cache in the policy (`kv_cache_format`), the attention
records max|k| (after RoPE) and max|v| at the sites '.../kv/{k,v}#A'.
Those observations touch no other site, so the other scales are those of
a calibration without the cache sites.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.scaling import context as scale_ctx
from repro_torch.scaling.state import (DelayedScaling, ScaleState,
                                       ScalingConfig, SiteRegistry)

FROZEN_SCALES_FILE = "frozen_scales.json"


def _delayed_eval_cfg(cfg: ModelConfig) -> ModelConfig:
    """Deterministic (RNE, saturating) config with delayed scaling on."""
    quant = dataclasses.replace(cfg.policy.quant.eval_mode(),
                                scaling="delayed")
    return cfg.replace(policy=dataclasses.replace(cfg.policy, quant=quant))


def _observe(params, ecfg: ModelConfig, batch: Dict[str, torch.Tensor],
             scales) -> Tuple[Dict[str, float], set]:
    """One calibration forward: {key: amax} (host floats) and the keys."""
    from repro_torch.models.transformer import encode, forward
    ctx = scale_ctx.calibrate_context(scales)
    with torch.no_grad(), scale_ctx.activate(ctx):
        enc_out = encode(params, batch["enc_inputs"], cfg=ecfg) \
            if ecfg.is_encoder_decoder else None
        forward(params, batch["tokens"], cfg=ecfg, mode="train",
                enc_out=enc_out, extra_embeds=batch.get("extra_embeds"))
    keys = list(ctx.collected)
    vals = torch.stack([ctx.collected[k].float() for k in keys]).cpu().numpy() \
        if keys else np.zeros((0,), np.float32)
    return dict(zip(keys, vals.astype(np.float32))), set(ctx.discovered)


def discover_lm_sites(cfg: ModelConfig, params, batch) -> SiteRegistry:
    """Site registry of the training loss (W/A/E/G sites and the token
    sites with backward observations), in the reference's key order.

    The reference traces `lm_loss` abstractly; eager torch has no abstract
    trace, so this runs the loss forward once, without gradients, on
    `batch` ({"tokens", "labels"}; a small one will do — the sites do not
    depend on its size) under a discovery context (unit scales, nothing
    recorded), with SR bits from a throwaway generator."""
    from repro_torch.models.transformer import lm_loss
    dcfg = cfg.replace(policy=dataclasses.replace(
        cfg.policy, quant=dataclasses.replace(cfg.policy.quant,
                                              scaling="delayed")))
    device = params["embed"]["table"].device
    gen = torch.Generator(device=device).manual_seed(0)
    ctx = scale_ctx.discover_context()
    with torch.no_grad(), scale_ctx.activate(ctx):
        lm_loss(params, batch, cfg=dcfg, qgen=gen)
    return SiteRegistry(ctx.discovered, ctx.discovered_token_sites)


def calibrate(params, cfg: ModelConfig, batches: Iterable, *,
              scaling_cfg: ScalingConfig = ScalingConfig(),
              registry: Optional[SiteRegistry] = None
              ) -> Tuple[DelayedScaling, ScaleState]:
    """Populate amax history from forward batches of {"tokens": (B, S)}
    (int tensors on the params' device, or numpy); an encoder-decoder's
    batches also hold "enc_inputs" (B, T, D), and a patch-stub model's
    may hold "extra_embeds" (B, P, D), which the forward prepends (the
    reference's calibration passes tokens only, so its batches are text).
    A mixture-of-experts model's expert sites ("moe/w_gate" ...), and a
    hybrid stack's RG-LRU projections (wx, wg, wa, wi, wo at the layer's
    scope) and local layers' KV-cache sites, are observed like any other. Returns the DelayedScaling bundle and the
    converged ScaleState."""
    cfg.check_ported()
    ecfg = _delayed_eval_cfg(cfg)
    device = params["embed"]["table"].device
    batches = list(batches)
    if ecfg.is_encoder_decoder and any("enc_inputs" not in b
                                       for b in batches):
        raise ValueError(
            "encoder-decoder calibration needs 'enc_inputs' in each batch "
            "(otherwise the encoder/cross-attention sites stay uncalibrated "
            "and serve with unit scales)")

    def on_dev(x, dtype):
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x, device=device).to(dtype)

    batches = [{"tokens": on_dev(b["tokens"], torch.long),
                **({"enc_inputs": on_dev(b["enc_inputs"], torch.float32)}
                   if ecfg.is_encoder_decoder else {}),
                **({"extra_embeds": on_dev(b["extra_embeds"], torch.float32)}
                   if "extra_embeds" in b else {})} for b in batches]
    ds = state = None
    for batch in batches:
        if ds is None:
            # Unit scales for the first batch (a fresh ScaleState's).
            observed, found = _observe(params, ecfg, batch, {})
            ds = DelayedScaling(registry or SiteRegistry(found),
                                config=scaling_cfg, qcfg=ecfg.policy.quant)
            state = ds.init()
        else:
            observed, _ = _observe(params, ecfg, batch,
                                   ds.scales_dict(state))
        state = ds.update(state, observed)
    return ds, state


def freeze(ds: DelayedScaling, state: ScaleState) -> Dict[str, float]:
    """Frozen per-site scales for serving (forward classes only)."""
    return ds.freeze(state)


def freeze_with_formats(ds: DelayedScaling, state: ScaleState,
                        cfg: Optional[ModelConfig] = None
                        ) -> Tuple[Dict[str, float], Dict[str, str]]:
    """(frozen scales, the format each was calibrated under); the KV-cache
    sites record `cfg.policy.kv_cache_format`. Serving refuses scales
    calibrated under another format (`frozen_formats=` of the engines)."""
    kv_format = cfg.policy.kv_cache_format if cfg is not None else None
    return ds.freeze(state), ds.frozen_formats(kv_format=kv_format)


def _stacks(cfg: ModelConfig):
    """(scope prefix, depth, kinds a group) of each layer stack, as the
    reference lays its scale sites out."""
    out = [("decoder/", cfg.n_layers, len(cfg.pattern()))]
    if cfg.is_encoder_decoder:
        out.append(("encoder/", cfg.n_encoder_layers, 1))
    return out


def _split_key(key: str, prefix: str):
    """(layer part, rest) of a key under `prefix` ("layer_3", "/wq#a.A"),
    or None."""
    if not key.startswith(prefix):
        return None
    head, sep, rest = key[len(prefix):].partition("/")
    return (head, sep + rest) if sep else None


def reference_keys(values: Dict[str, object], cfg: ModelConfig
                   ) -> Dict[str, object]:
    """Port keys -> the reference's, for a frozen-scales or formats dict
    of `cfg`: the remainder layers after the groups of a block pattern
    that does not divide the depth (`layer_{n_groups * len(pattern) + i}`
    here) under `rem_{i}`; and where the reference scans the stack
    (`cfg.scan_layers` and more than one group), each group position's
    layers under `stack_{p}`, a list of one value a layer in group order
    (its `freeze(per_layer=True)` layout, which its serving threads
    through the scan) or, for formats, the one value they share. Other
    keys pass through."""
    out: Dict[str, object] = {}
    stacked: Dict[str, Dict[int, object]] = {}
    for key, value in values.items():
        for prefix, depth, kinds in _stacks(cfg):
            parts = _split_key(key, prefix)
            if parts is None or not parts[0].startswith("layer_"):
                continue
            i, rest = int(parts[0][len("layer_"):]), parts[1]
            n_groups = depth // kinds
            base = n_groups * kinds
            if i >= base:
                key = f"{prefix}rem_{i - base}{rest}"
            elif cfg.scan_layers and n_groups > 1:
                stacked.setdefault(f"{prefix}stack_{i % kinds}{rest}",
                                   {})[i // kinds] = value
                key = None
            break
        if key is not None:
            out[key] = value
    for key, by_group in stacked.items():
        vals = [by_group[g] for g in sorted(by_group)]
        out[key] = vals[0] if all(isinstance(v, str) for v in vals) \
            else [float(v) for v in vals]
    return out


def port_keys(values: Dict[str, object], cfg: ModelConfig
              ) -> Dict[str, object]:
    """The reference's keys -> the port's (`reference_keys` inverted, as
    `models.convert` splits its parameter stacks): `rem_{i}` to the
    remainder layer's `layer_{...}`, and `stack_{p}` to each of the
    position's layers, with its own value from a per-layer list or the
    shared value (a max envelope, or a format) otherwise."""
    out: Dict[str, object] = {}
    for key, value in values.items():
        for prefix, depth, kinds in _stacks(cfg):
            parts = _split_key(key, prefix)
            if parts is None:
                continue
            head, rest = parts
            n_groups = depth // kinds
            if head.startswith("rem_"):
                key = f"{prefix}layer_{n_groups * kinds + int(head[4:])}" \
                    + rest
            elif head.startswith("stack_"):
                pos = int(head[len("stack_"):])
                for g in range(n_groups):
                    out[f"{prefix}layer_{g * kinds + pos}{rest}"] = \
                        value[g] if isinstance(value, list) else value
                key = None
            break
        if key is not None:
            out[key] = value
    return out


def save_frozen(directory, scales: Dict[str, float],
                formats: Optional[Dict[str, str]] = None, *,
                cfg: ModelConfig):
    """Write FROZEN_SCALES_FILE in `directory` under the reference's keys
    for `cfg` (`reference_keys`), so its `load_frozen` serves the file:
    {"scales", "formats"}, or the plain legacy {key: scale} layout without
    `formats` (the reference's file, byte for byte)."""
    scales = reference_keys(scales, cfg)
    formats = None if formats is None else reference_keys(formats, cfg)
    p = Path(directory)
    p.mkdir(parents=True, exist_ok=True)
    doc = scales if formats is None else {"scales": scales,
                                          "formats": formats}
    (p / FROZEN_SCALES_FILE).write_text(json.dumps(doc, indent=1,
                                                   sort_keys=True))


def _load_doc(directory) -> dict:
    return json.loads((Path(directory) / FROZEN_SCALES_FILE).read_text())


def load_frozen(directory, cfg: ModelConfig) -> Dict[str, float]:
    """The scales of a frozen-scales file (the reference's keys for `cfg`,
    its remainder layers under `rem_{i}`, its scanned stacks under
    `stack_{p}`) under the port's keys (`port_keys`)."""
    doc = _load_doc(directory)
    scales = doc["scales"] if isinstance(doc.get("scales"), dict) else doc
    return port_keys(scales, cfg)


def load_frozen_formats(directory, cfg: ModelConfig) -> Dict[str, str]:
    """The formats of a frozen-scales file ({} for the legacy layout)
    under the port's keys for `cfg`."""
    doc = _load_doc(directory)
    formats = doc.get("formats", {}) if isinstance(doc.get("scales"), dict) \
        else {}
    return port_keys(formats, cfg)
