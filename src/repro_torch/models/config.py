"""Model configuration (counterpart of `repro.models.config`)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.precision_policy import PAPER_POLICY, PrecisionPolicy


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Same fields and defaults as the reference. The port runs attention
    decoders (dense and mixture-of-experts), the RG-LRU / local-attention
    hybrid, the xLSTM stack (mLSTM and sLSTM blocks) and
    encoder-decoders."""
    arch: str = "custom"
    family: str = "dense"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"
    rope_theta: float = 10_000.0
    max_seq_len: int = 8192

    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_per_sample_dispatch: bool = True

    block_pattern: Tuple[str, ...] = ()
    window: int = 0
    lru_dim: int = 0
    ssm_proj_factor: float = 2.0

    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    frontend: Optional[str] = None
    n_frontend_tokens: int = 0

    policy: PrecisionPolicy = PAPER_POLICY
    remat: bool = True
    # The port always runs its layers in a Python loop (site keys are the
    # reference's `scan_layers=False` keys); the field is kept for parity.
    scan_layers: bool = True
    sequence_parallel: bool = False
    attn_chunk_threshold: int = 2048
    attn_chunk_size: int = 1024

    @property
    def padded_vocab_size(self) -> int:
        return -(-self.vocab_size // 16) * 16

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def pattern(self) -> Tuple[str, ...]:
        return self.block_pattern if self.block_pattern else ("attn",)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def layer_kinds(self) -> Tuple[str, ...]:
        pat = self.pattern()
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Approximate parameter count (embedding + layers + head), the
        reference's formula for every family."""
        d, dh = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        for kind in self.layer_kinds():
            if kind in ("attn", "local_attn"):
                per_layer += d * (self.n_heads * dh + 2 * self.n_kv_heads * dh)
                per_layer += self.n_heads * dh * d
            elif kind == "rglru":
                w = self.lru_dim or self.d_model
                per_layer += 2 * d * w + 3 * w + w * d
            elif kind in ("mlstm", "slstm"):
                inner = int(d * self.ssm_proj_factor)
                per_layer += 2 * d * inner + 4 * inner * inner // 4 + inner * d
            if kind not in ("mlstm", "slstm"):
                if self.n_experts:
                    per_layer += (self.n_experts * 3 * d * self.d_ff
                                  + d * self.n_experts)
                elif self.d_ff:
                    per_layer += 3 * d * self.d_ff
        enc = 0
        if self.is_encoder_decoder:
            enc = self.n_encoder_layers * (4 * d * d + 3 * d * self.d_ff
                                           + 2 * d * d)
        return emb + per_layer + enc

    def check_ported(self, *, serving: bool = False, paged: bool = False):
        """Raise for what the port does not run: a layer kind or frontend
        the reference does not define; with serving=True (the engines,
        paged serving) also an encoder-decoder, which the reference's
        engines do not serve either; with paged=True (paged serving: its
        pools, engine and chunk step) also any layer kind but attention,
        as the reference's `init_paged_stack_state` refuses (ValueError).
        Attention decoders (dense or with the mixture-of-experts FFN, with
        or without the patch stub's prefix), the RG-LRU / local-attention
        hybrid, the xLSTM stack and encoder-decoders (with or without the
        frame stub) run."""
        bad = [k for k in self.pattern()
               if k not in ("attn", "local_attn", "rglru", "mlstm", "slstm")]
        if bad:
            raise NotImplementedError(
                f"arch {self.arch!r}: layer kinds {sorted(set(bad))} are not "
                "layer kinds of the reference (attn, local_attn, rglru, "
                "mlstm, slstm); ROADMAP.md lists what the port runs")
        if self.frontend not in (None, "patch_stub", "audio_stub"):
            raise NotImplementedError(
                f"arch {self.arch!r}: frontend {self.frontend!r} is not "
                "ported (ROADMAP.md)")
        if serving and self.is_encoder_decoder:
            raise NotImplementedError(
                f"arch {self.arch!r}: the serving engines and paged serving "
                "do not serve an encoder-decoder, as the reference's do not "
                "(its engine's prefill reads batch['enc_inputs'], which "
                "add_request never passes; its chunk step passes no "
                "enc_out); serve one through train.step.make_serve_prefill "
                "/ make_serve_decode")
        if paged:
            kinds = [k for k in self.pattern()
                     if k not in ("attn", "local_attn")]
            if kinds:
                raise ValueError(f"paged serving supports attention stacks "
                                 f"only, got layer kinds {kinds}")
