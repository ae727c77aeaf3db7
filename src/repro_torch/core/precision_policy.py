"""Precision policy: which tensor gets which format/rounding/saturation.

Counterpart of `repro.core.precision_policy` (the paper's recipe and the
hybrid e4m3/e5m2 recipe, per tensor class W/A/E/G) and the distribution
policy `DistConfig` that `distributed.strategy.ParallelPlan.build` reads.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

WEIGHT, ACT, ERROR, GRAD = "weight", "act", "error", "grad"


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static quantization configuration (same fields and defaults as the
    reference). The recipe owns fwd_format/bwd_format."""
    enabled: bool = True
    recipe: str = "paper_e5m2"
    fwd_format: str = "e5m2"
    bwd_format: str = "e5m2"
    weight_rounding: str = "rne"
    act_rounding: str = "sr"
    error_rounding: str = "sr"
    grad_rounding: str = "sr"
    saturate_fwd: bool = True
    saturate_bwd: bool = False
    scaling: str = "none"
    amax_scale_fwd: bool = False
    amax_scale_bwd: bool = False
    compute_dtype: str = "bfloat16"
    output_dtype: str = "bfloat16"
    accum_dtype: str = "float32"
    # xla | pallas | pallas_interpret in the reference; the port reads only
    # whether a kernel backend ("pallas*") is selected.
    backend: str = "xla"
    quantize_attention: bool = True
    fuse_epilogue: bool = True
    fuse_attention: bool = True
    attn_block_q: Optional[int] = None
    attn_block_kv: Optional[int] = None
    autotune: str = "table"
    track_health: bool = False

    def __post_init__(self):
        if self.recipe == "paper_e5m2":
            object.__setattr__(self, "fwd_format", "e5m2")
            object.__setattr__(self, "bwd_format", "e5m2")
        elif self.recipe == "hybrid":
            object.__setattr__(self, "fwd_format", "e4m3")
            object.__setattr__(self, "bwd_format", "e5m2")
        else:
            raise ValueError(f"unknown format recipe {self.recipe!r}")
        if self.scaling not in ("none", "jit_amax", "delayed"):
            raise ValueError(f"unknown scaling mode {self.scaling!r}")
        if self.scaling == "none" and (self.amax_scale_fwd
                                       or self.amax_scale_bwd):
            object.__setattr__(self, "scaling", "jit_amax")

    def rounding_for(self, cls: str) -> str:
        return {WEIGHT: self.weight_rounding, ACT: self.act_rounding,
                ERROR: self.error_rounding, GRAD: self.grad_rounding}[cls]

    def format_for(self, cls: str) -> str:
        return self.fwd_format if cls in (WEIGHT, ACT) else self.bwd_format

    def saturate_for(self, cls: str) -> bool:
        return self.saturate_fwd if cls in (WEIGHT, ACT) else self.saturate_bwd

    def amax_for(self, cls: str) -> bool:
        """Just-in-time amax scaling for `cls`? scaling="jit_amax" given
        directly scales every class; the deprecated amax_scale_fwd /
        amax_scale_bwd shims select the forward (W, A) or backward (E, G)
        classes. Delayed scaling never reduces inline."""
        if self.scaling != "jit_amax":
            return False
        if not (self.amax_scale_fwd or self.amax_scale_bwd):
            return True
        return self.amax_scale_fwd if cls in (WEIGHT, ACT) \
            else self.amax_scale_bwd

    @property
    def delayed(self) -> bool:
        return self.scaling == "delayed"

    @property
    def needs_key(self) -> bool:
        """SR somewhere: the call sites then need the step's generator."""
        return self.enabled and "sr" in (self.weight_rounding,
                                         self.act_rounding,
                                         self.error_rounding,
                                         self.grad_rounding)

    def eval_mode(self) -> "QuantConfig":
        """Deterministic inference variant: RNE everywhere, saturating."""
        return dataclasses.replace(self, act_rounding="rne", error_rounding="rne",
                                   grad_rounding="rne", saturate_bwd=True)

    def baseline(self) -> "QuantConfig":
        return dataclasses.replace(self, enabled=False)

    def recipe_table(self) -> dict:
        return {cls: dict(format=self.format_for(cls),
                          rounding=self.rounding_for(cls),
                          saturate=self.saturate_for(cls))
                for cls in (WEIGHT, ACT, ERROR, GRAD)}


PAPER_FP8 = QuantConfig()
PAPER_FP8_RNE = dataclasses.replace(
    PAPER_FP8, act_rounding="rne", error_rounding="rne", grad_rounding="rne")
BASELINE = QuantConfig(enabled=False)
DELAYED_FP8 = dataclasses.replace(PAPER_FP8, scaling="delayed")
HYBRID_FP8 = QuantConfig(recipe="hybrid")
HYBRID_DELAYED_FP8 = QuantConfig(recipe="hybrid", scaling="delayed")


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Static parallelism policy (the reference's fields, defaults and
    errors): which strategies compose into the ParallelPlan and what format
    the collectives put on the wire.

    wire: the data-parallel gradient reduction — "full" (f32 sums) or
    "fp8_ef" (the e5m2 error-feedback all-reduce of
    `distributed.grad_compress`, the residual riding the train state).
    wire_zero_gather: the ZeRO-1 weight all-gather leg, "full" or "fp8"
    (e4m3 payloads). wire_axis: the mesh dim the compressed reduction runs
    over; None takes the slowest data-parallel link present ('pod' if the
    mesh has it, else 'data')."""
    dp: bool = True
    zero1: bool = True
    tp: bool = True
    wire: str = "full"
    wire_zero_gather: str = "full"
    wire_axis: Optional[str] = None

    def __post_init__(self):
        if self.wire not in ("full", "fp8_ef"):
            raise ValueError(f"unknown wire format {self.wire!r}")
        if self.wire_zero_gather not in ("full", "fp8"):
            raise ValueError(
                f"unknown zero-gather format {self.wire_zero_gather!r}")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Model-level policy: where FP8 applies and master-weight precision."""
    quant: QuantConfig = PAPER_FP8
    dist: DistConfig = DistConfig()
    quantize_embedding: bool = False
    quantize_logits_head: bool = False
    master_weight_dtype: str = "float16"
    update_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    # FP8 KV cache: None (bf16), "e5m2" or "e4m3".
    kv_cache_format: Optional[str] = None

    def quant_for_layer(self, *, is_embedding: bool = False,
                        is_head: bool = False) -> QuantConfig:
        if (is_embedding and not self.quantize_embedding) or \
           (is_head and not self.quantize_logits_head):
            return self.quant.baseline()
        return self.quant


PAPER_POLICY = PrecisionPolicy()
BASELINE_POLICY = PrecisionPolicy(quant=BASELINE, master_weight_dtype="float32")


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]
