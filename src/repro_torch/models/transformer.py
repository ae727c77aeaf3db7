"""Decoder, hybrid and encoder-decoder LM assembly (counterpart of
`repro.models.transformer`).

Parameters are nested dicts of tensors laid out like the reference's
unscanned tree: {"embed": {"table"[, "head"]}, "final_norm": {"scale"},
"decoder": {"layer_{i}": {...}}}, and for an encoder-decoder also
"encoder": {"layer_{i}": {...}} and "enc_norm", with "cross_norm" /
"cross_attn" in each decoder layer. Layers run in a plain Python loop (the
reference's lax.scan), each under the site scope of its key, so scale-site
keys are the reference's `scan_layers=False` keys (the encoder's under
"encoder/", a decoder layer's cross-attention under ".../cross_attn/"),
except that the reference's unrolled remainder layers `rem_{i}` (a block
pattern that does not divide the depth) are the port's
`layer_{n_groups * len(pattern) + i}`, in the same order
(`scaling.calibrate.reference_keys` / `port_keys` map a frozen-scales
file's keys between the two layouts).

Layer kinds follow the config's block pattern (`cfg.layer_kinds()`):
'attn' (self-attention), 'local_attn' (self-attention within
`cfg.window` positions, with a ring of that many cache slots), each with
the gated MLP or the mixture-of-experts FFN; 'rglru' (the RG-LRU block,
`models.rglru`, whose sites sit at the layer's scope, then the gated MLP
under "mlp" when `cfg.d_ff`); 'mlstm' and 'slstm' (the xLSTM blocks,
`models.xlstm`, after `norm1`, their sites at the layer's scope, no MLP).

`lm_loss` is the training objective (the reference's `lm_loss` with its
sequence-chunked cross-entropy `_chunked_ce`): the 16-bit logits head, a
mask over the padded vocabulary, the mean NLL over the loss mask, times
the loss scale. Autograd differentiates it; the FP8 GEMMs and attention
carry their own custom gradients, and save fp8 payloads for the backward.

Activation recomputation follows the reference's scanned stack: with
`cfg.remat` and `cfg.scan_layers` (both on by default) and more than one
group of the block pattern, each layer of a stack's groups (the
decoder's, and the encoder's) is recomputed in the training backward
(`models.remat.checkpointed`), an RG-LRU layer like any other, exactly
where the reference's `jax.checkpoint` of the scan body recomputes it
(an xLSTM layer too, and within it each mLSTM chunk as the reference's
`_mlstm_parallel` checkpoints it);
the remainder layers after the groups, and every layer with
`scan_layers=False`, are not recomputed there, and neither are they here.

Serving an encoder-decoder (`forward(..., enc_out=)` in the prefill and
decode modes): the decoder's self-attention caches as a decoder's do; the
cross-attention has no cache and projects `enc_out` at every step, as the
reference does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.precision_policy import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import (attention, init_attention,
                                          init_cache, init_paged_pool)
from repro_torch.distributed import tensor_parallel
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dense_init, embed, embed_init,
                                       logits_head, mlp, rmsnorm,
                                       vocab_shard)
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.models.remat import checkpointed
from repro_torch.models.rglru import (init_rglru, init_rglru_state,
                                      rglru_block)
from repro_torch.models.xlstm import (init_mlstm, init_mlstm_state,
                                      init_slstm, init_slstm_state,
                                      mlstm_block, slstm_block)
from repro_torch.scaling import context as scale_ctx


# The xLSTM kinds: (init, state init).
_XLSTM = {"mlstm": (init_mlstm, init_mlstm_state),
          "slstm": (init_slstm, init_slstm_state)}


def _layer_names(cfg: ModelConfig):
    """Decoder keys in execution order, the remainder layers of a block
    pattern that does not divide the depth included (38 = 12 x 3 + 2:
    layer_0 .. layer_37); `cfg.layer_kinds()` gives each one's kind."""
    return [f"layer_{i}" for i in range(cfg.n_layers)]


def _mlp_init(cfg: ModelConfig, **kw):
    return {"up": dense_init(cfg.d_model, cfg.d_ff, **kw),
            "down": dense_init(cfg.d_ff, cfg.d_model, scale=0.5, **kw),
            "gate": dense_init(cfg.d_model, cfg.d_ff, **kw)}


def init_layer(cfg: ModelConfig, *, generator, device,
               cross: bool = False, kind: str = "attn"):
    """One layer of `kind`: 'attn' / 'local_attn', self-attention and the
    gated MLP (the mixture-of-experts FFN, "moe", when `cfg.n_experts`),
    with a cross-attention block between them for an encoder-decoder's
    decoder (cross=True); 'rglru', the RG-LRU block and, when `cfg.d_ff`,
    the gated MLP; 'mlstm' / 'slstm', the xLSTM block alone."""
    kw = dict(generator=generator, device=device)
    ones = torch.ones((cfg.d_model,), dtype=torch.float32, device=device)
    if kind in _XLSTM:
        return {"norm1": {"scale": ones.clone()},
                kind: _XLSTM[kind][0](cfg, **kw)}
    if kind == "rglru":
        p = {"norm1": {"scale": ones.clone()},
             "rglru": init_rglru(cfg, **kw)}
        if cfg.d_ff:
            p["norm2"] = {"scale": ones.clone()}
            p["mlp"] = _mlp_init(cfg, **kw)
        return p
    if kind not in ("attn", "local_attn"):
        raise ValueError(f"unknown layer kind {kind!r}")
    p = {"norm1": {"scale": ones.clone()},
         "attn": init_attention(cfg, **kw)}
    if cross:
        p["cross_norm"] = {"scale": ones.clone()}
        p["cross_attn"] = init_attention(cfg, **kw)
    p["norm2"] = {"scale": ones.clone()}
    if cfg.n_experts:
        p["moe"] = init_moe(cfg, **kw)
    else:
        p["mlp"] = _mlp_init(cfg, **kw)
    return p


def init_lm(cfg: ModelConfig, *, seed: int = 0, device=None):
    """Random weights drawn from `seed` (a torch.Generator on the target
    device), with the reference's shapes and initializer distributions."""
    cfg.check_ported()
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: Dict[str, Any] = {
        "embed": {"table": embed_init(cfg.padded_vocab_size, cfg.d_model,
                                      generator=gen, device=dev)},
        "final_norm": {"scale": torch.ones((cfg.d_model,),
                                           dtype=torch.float32, device=dev)},
        "decoder": {name: init_layer(cfg, generator=gen, device=dev,
                                     cross=cfg.is_encoder_decoder, kind=kind)
                    for name, kind in zip(_layer_names(cfg),
                                          cfg.layer_kinds())},
    }
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            f"layer_{i}": init_layer(cfg, generator=gen, device=dev)
            for i in range(cfg.n_encoder_layers)}
        params["enc_norm"] = {"scale": torch.ones(
            (cfg.d_model,), dtype=torch.float32, device=dev)}
    if not cfg.tie_embeddings:
        params["embed"]["head"] = dense_init(
            cfg.d_model, cfg.padded_vocab_size, scale=0.5, generator=gen,
            device=dev)
    return params


def init_layer_state(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     *, device):
    """One layer's fixed-slot serving state: {"kv": init_cache} for an
    attention layer (a ring of `cfg.window` slots for 'local_attn'), {"rec":
    init_rglru_state} for an RG-LRU layer, {"rec": init_mlstm_state /
    init_slstm_state} for an xLSTM layer."""
    if kind == "rglru":
        return {"rec": init_rglru_state(cfg, batch, device=device)}
    if kind in _XLSTM:
        return {"rec": _XLSTM[kind][1](cfg, batch, device=device)}
    window = cfg.window if kind == "local_attn" else 0
    return {"kv": init_cache(cfg, batch, max_len, device=device,
                             window=window)}


def init_stack_state(cfg: ModelConfig, batch: int, max_len: int, *,
                     device=None):
    """Per-layer fixed-slot serving states (`init_layer_state`), keyed like
    the decoder params: the self-attention's caches only (an
    encoder-decoder's cross-attention keeps no cache)."""
    cfg.check_ported()
    dev = resolve_device(device)
    return {name: init_layer_state(cfg, kind, batch, max_len, device=dev)
            for name, kind in zip(_layer_names(cfg), cfg.layer_kinds())}


def init_paged_stack_state(cfg: ModelConfig, n_slots: int, *, device=None):
    """Per-layer paged KV pools, keyed like the decoder params. An
    attention-stack feature: other layer kinds are refused (ValueError),
    as the reference refuses them."""
    cfg.check_ported(serving=True, paged=True)
    dev = resolve_device(device)
    return {name: {"kv": init_paged_pool(cfg, n_slots, device=dev)}
            for name in _layer_names(cfg)}


def _write_rec(rec, new, page):
    """A recurrent layer's state after a prefill or decode (each tensor the
    block returns: RG-LRU h and conv, mLSTM C, n and m, sLSTM h, c, n and
    m), written into the carried `rec` in place: every row, or with
    page["slot"] (the fixed-slot engine's admission) that row alone, as
    the reference's _merge_slot takes it."""
    rows = slice(None) if page is None else slice(page["slot"],
                                                   page["slot"] + 1)
    for name, value in new.items():
        rec[name][rows] = value[rows].to(rec[name].dtype)
    return rec


def apply_layer(p, h: torch.Tensor, *, cfg: ModelConfig, qcfg: QuantConfig,
                positions: torch.Tensor, mode: str, state=None, page=None,
                enc_out: Optional[torch.Tensor] = None,
                qgen: Optional[torch.Generator] = None, kind: str = "attn"):
    """One layer of `kind`: a decoder layer ('attn' or 'local_attn'; with
    enc_out, its cross-attention block too), or with mode 'encode' an
    encoder layer, or an RG-LRU layer ('rglru': its state {"rec"} carried
    in place; a prefill starts the conv from the row's carried window, as
    the reference's does, and h from zero), or an xLSTM layer ('mlstm',
    'slstm': its state {"rec"} carried in place; an mLSTM prefill starts
    from zero, an sLSTM prefill from the row's carried state, as the
    reference's do). Returns (h, new_state, aux): aux holds the
    mixture-of-experts FFN's aux losses ({} otherwise)."""
    if kind in _XLSTM:
        rec = None if state is None else state["rec"]
        block = mlstm_block if kind == "mlstm" else slstm_block
        r, new_rec = block(
            p[kind], rmsnorm(p["norm1"], h, eps=cfg.norm_eps), cfg=cfg,
            qcfg=qcfg, mode=mode, state=rec, qgen=qgen)
        h = h + r
        if new_rec is None:
            return h, None, {}
        return h, {"rec": _write_rec(rec, new_rec, page)}, {}
    if kind == "rglru":
        rec = None if state is None else state["rec"]
        r, new_rec = rglru_block(
            p["rglru"], rmsnorm(p["norm1"], h, eps=cfg.norm_eps), cfg=cfg,
            qcfg=qcfg, mode=mode, state=rec, qgen=qgen)
        h = h + r
        if "mlp" in p:
            with scale_ctx.scope("mlp"):
                h = h + mlp(p["mlp"], rmsnorm(p["norm2"], h,
                                              eps=cfg.norm_eps),
                            act=cfg.act, qcfg=qcfg, qgen=qgen)
        if new_rec is None:
            return h, None, {}
        return h, {"rec": _write_rec(rec, new_rec, page)}, {}
    window = cfg.window if kind == "local_attn" else 0
    with scale_ctx.scope("attn"):
        a, cache = attention(
            p["attn"], rmsnorm(p["norm1"], h, eps=cfg.norm_eps), cfg=cfg,
            qcfg=qcfg, positions=positions, mode=mode,
            cache_layer=None if state is None else state["kv"],
            window=window, page=page, qgen=qgen)
    h = h + a
    if "cross_attn" in p and enc_out is not None:
        with scale_ctx.scope("cross_attn"):
            ca, _ = attention(
                p["cross_attn"], rmsnorm(p["cross_norm"], h,
                                         eps=cfg.norm_eps),
                cfg=cfg, qcfg=qcfg, positions=positions, mode="cross",
                kv_x=enc_out, qgen=qgen)
        h = h + ca
    aux = {}
    if "moe" in p:
        with scale_ctx.scope("moe"):
            f, aux = moe_ffn(p["moe"], rmsnorm(p["norm2"], h,
                                               eps=cfg.norm_eps),
                             cfg=cfg, qcfg=qcfg, qgen=qgen)
    else:
        with scale_ctx.scope("mlp"):
            f = mlp(p["mlp"], rmsnorm(p["norm2"], h, eps=cfg.norm_eps),
                    act=cfg.act, qcfg=qcfg, qgen=qgen)
    h = h + f
    return h, (None if cache is None else {"kv": cache}), aux


def merge_aux(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]):
    """Accumulate layers' aux losses into `dst` by sum (the reference's
    `_merge_aux`; its amax and health entries, which max-combine, live in
    the port's scaling context instead)."""
    for k, v in src.items():
        dst[k] = dst[k] + v if k in dst else v
    return dst


def _remat(cfg: ModelConfig, n_layers: int, n_kinds: int = 1) -> int:
    """How many of a training stack's leading layers are recomputed: where
    the reference's scanned stack does (remat on, scanned layers, more
    than one group of the block pattern), its groups' layers; not the
    remainder layers it applies unrolled after the scan."""
    n_groups = n_layers // n_kinds
    return n_groups * n_kinds \
        if cfg.remat and cfg.scan_layers and n_groups > 1 else 0


def _apply_stack_layer(p, h, *, remat: bool, qgen, **kw):
    """apply_layer, recomputed in the backward when `remat` (training
    modes only: no cache state). The layer's aux losses leave the
    checkpointed region as outputs of its first forward, with their
    gradients; the recomputation's are discarded."""
    if not remat:
        return apply_layer(p, h, qgen=qgen, **kw)

    def region(g, hh):
        out, _, aux = apply_layer(p, hh, qgen=g, **kw)
        return out, aux

    h, aux = checkpointed(region, qgen, h)
    return h, None, aux


def _backbone(params, tokens, *, cfg: ModelConfig, mode: str, states,
              positions, page, qgen, enc_out=None, extra_embeds=None):
    """Embedding (after the `extra_embeds` prefix (B, P, D), if given) and
    decoder layers. Returns (h, new_states, aux), aux the layers' aux
    losses summed."""
    qcfg = cfg.policy.quant
    h = embed(params["embed"], tokens)
    if extra_embeds is not None:
        h = torch.cat([torch.as_tensor(extra_embeds).to(
            device=h.device, dtype=h.dtype), h], dim=1)
    b, s, _ = h.shape
    if positions is None:
        positions = torch.arange(s, device=h.device)[None].expand(b, s)
    new_states = {} if states is not None else None
    aux: Dict[str, torch.Tensor] = {}
    n_remat = _remat(cfg, cfg.n_layers, len(cfg.pattern())) \
        if mode == "train" else 0
    with scale_ctx.scope("decoder"):
        for i, (name, kind) in enumerate(zip(_layer_names(cfg),
                                             cfg.layer_kinds())):
            with scale_ctx.scope(name):
                h, ns, layer_aux = _apply_stack_layer(
                    params["decoder"][name], h, remat=i < n_remat, qgen=qgen,
                    cfg=cfg, qcfg=qcfg, positions=positions, mode=mode,
                    state=None if states is None else states[name],
                    page=page, enc_out=enc_out, kind=kind)
            merge_aux(aux, layer_aux)
            if states is not None:
                new_states[name] = ns
    return h, new_states, aux


def encode(params, enc_inputs, *, cfg: ModelConfig,
           qgen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Encoder forward: enc_inputs (B, T, D) precomputed frame embeddings
    (f32, numpy or a tensor) -> the normalized encoder output (B, T, D)
    bf16. The encoder's layers are the 'enc_attn' kind: bidirectional
    attention (mode 'encode') under the scope "encoder"."""
    qcfg = cfg.policy.quant
    dev = params["enc_norm"]["scale"].device
    h = torch.as_tensor(enc_inputs).to(device=dev).to(torch.bfloat16)
    b, t, _ = h.shape
    positions = torch.arange(t, device=dev)[None].expand(b, t)
    remat = _remat(cfg, cfg.n_encoder_layers) > 0
    with scale_ctx.scope("encoder"):
        for i in range(cfg.n_encoder_layers):
            name = f"layer_{i}"
            with scale_ctx.scope(name):
                h, _, _ = _apply_stack_layer(
                    params["encoder"][name], h, remat=remat, qgen=qgen,
                    cfg=cfg, qcfg=qcfg, positions=positions, mode="encode")
    return rmsnorm(params["enc_norm"], h, eps=cfg.norm_eps)


def forward(params, tokens: torch.Tensor, *, cfg: ModelConfig,
            mode: str = "train", states=None,
            positions: Optional[torch.Tensor] = None, page=None,
            gather_rows: Optional[torch.Tensor] = None,
            last_only: bool = False,
            enc_out: Optional[torch.Tensor] = None,
            extra_embeds=None, qgen: Optional[torch.Generator] = None):
    """Backbone forward. Returns (logits, new_states).

    mode 'train' (causal, no cache); 'prefill' / 'decode' (fixed-slot
    serving: `states` are the caches of init_stack_state, written in
    place; prefill writes only batch row page["slot"] when `page` is
    given); or 'chunk' (paged serving:
    `states` are the pools of init_paged_stack_state, `page` the step's
    block-table indirection). last_only: logits of the last position only
    (prefill). gather_rows: (B,) row per request at which to compute
    logits (the chunk's last valid token). enc_out: an encoder-decoder's
    encoder output (`encode`), the cross-attention's keys and values (the
    decoder runs without cross-attention when it is None, as the
    reference's does). extra_embeds: (B, P, D) precomputed patch
    embeddings prepended to the token embeddings (the patch stub; the
    positions then count the prefix). qgen: the generator SR bits come
    from."""
    cfg.check_ported()
    head_cfg = cfg.policy.quant_for_layer(is_head=True)
    h, new_states, _ = _backbone(
        params, tokens, cfg=cfg, mode=mode, states=states,
        positions=positions, page=page, qgen=qgen, enc_out=enc_out,
        extra_embeds=extra_embeds)
    b = h.shape[0]
    if last_only:
        h = h[:, -1:]
    elif gather_rows is not None:
        h = h[torch.arange(b, device=h.device), gather_rows.long()][:, None]
    h = rmsnorm(params["final_norm"], h, eps=cfg.norm_eps)
    logits = logits_head(params["embed"], h, qcfg=head_cfg)
    return logits, new_states


def _chunked_ce(params, h, labels, mask, *, cfg: ModelConfig,
                head_cfg: QuantConfig, chunk: int) -> torch.Tensor:
    """Sum over positions of mask * (logsumexp - gold logit), computed per
    sequence chunk of `chunk` positions ((B, chunk, V) logits at a time),
    with the padded vocabulary columns masked to -1e30. Under a 'model'
    group with a vocab-parallel head (`layers.vocab_shard`) each rank
    holds (B, chunk, V / m) logits, its vocabulary columns
    (`_vocab_parallel_ce`)."""
    s = h.shape[1]
    shard = vocab_shard(params["embed"])
    v0 = shard[1] if shard is not None else 0
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        lf = logits_head(params["embed"], h[:, c0:c1], qcfg=head_cfg).float()
        if cfg.padded_vocab_size != cfg.vocab_size:
            col = torch.arange(v0, v0 + lf.shape[-1], device=lf.device)
            lf = torch.where(col < cfg.vocab_size, lf,
                             torch.full_like(lf, -1e30))
        lab = labels[:, c0:c1].long()
        if shard is None:
            logz = torch.logsumexp(lf, dim=-1)
            gold = torch.gather(lf, -1, lab[..., None])[..., 0]
        else:
            logz, gold = _vocab_parallel_ce(lf, lab, v0, shard[0])
        total = total + torch.sum((logz - gold) * mask[:, c0:c1])
    return total


def _vocab_parallel_ce(lf, labels, v0: int, tp):
    """(logsumexp, gold logit) of each row from this rank's logit columns
    [v0, v0 + V/m): the row max by a MAX over the ranks (outside autograd:
    the logsumexp's gradient does not depend on it), the sum of exp and
    the gold logit (its owner's, zero elsewhere) summed over the ranks in
    one collective whose backward is the identity on every rank."""
    v = lf.shape[-1]
    with torch.no_grad():
        gmax = tensor_parallel.rank_max(lf.amax(dim=-1), tp)
    local = labels - v0
    mine = (local >= 0) & (local < v)
    g = torch.gather(lf, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    part = torch.stack([torch.exp(lf - gmax[..., None]).sum(dim=-1),
                        torch.where(mine, g, torch.zeros_like(g))])
    sumexp, gold = tensor_parallel.reduce_from(part, tp).unbind(0)
    return torch.log(sumexp) + gmax, gold


def lm_loss(params, batch: Dict[str, Any], *, cfg: ModelConfig,
            qgen: Optional[torch.Generator] = None,
            loss_scale: Optional[torch.Tensor] = None,
            loss_denom: Optional[torch.Tensor] = None):
    """Causal-LM (or seq2seq) cross-entropy plus the layers' aux losses.
    batch: {"tokens", "labels"} (B, S) int and an optional "loss_mask"
    (B, S), tensors on the params' device or numpy; an encoder-decoder's
    batch also holds "enc_inputs" (B, T, D), which `encode` turns into the
    decoder's cross-attention input (the encoder runs first, as in the
    reference); a patch-stub batch may hold "extra_embeds" (B, P, D),
    prepended to the token embeddings, with labels and mask zero-padded
    over the prefix. Returns (loss, metrics): metrics {"nll", and each aux
    entry summed over the layers}; the loss is the nll plus every aux
    entry (the mixture-of-experts' lb_loss, router_z_loss and
    dropped_frac, as the reference adds every aux entry that is not an
    observation). With `loss_scale` (a 0-d tensor) the loss is multiplied
    by it (scale before backprop, unscale in the optimizer). `loss_denom`
    (a 0-d f32 tensor) replaces the batch's own max(mask sum, 1) as the
    nll's divisor: a data-parallel rank's shard divides by the global
    batch's count, as the reference's one program over the global batch
    does."""
    cfg.check_ported()
    enc_out = encode(params, batch["enc_inputs"], cfg=cfg, qgen=qgen) \
        if cfg.is_encoder_decoder else None
    head_cfg = cfg.policy.quant_for_layer(is_head=True)
    dev = params["embed"]["table"].device

    def on_dev(x, dtype):
        return torch.as_tensor(x).to(device=dev, dtype=dtype)

    tokens = on_dev(batch["tokens"], torch.long)
    labels = on_dev(batch["labels"], torch.long)
    mask = batch.get("loss_mask")
    mask = torch.ones(labels.shape, dtype=torch.float32, device=dev) \
        if mask is None else on_dev(mask, torch.float32)
    extra = batch.get("extra_embeds")
    if extra is not None:
        extra = on_dev(extra, torch.float32)
        pad = (extra.shape[1], 0)
        labels = torch.nn.functional.pad(labels, pad)
        mask = torch.nn.functional.pad(mask, pad)
    h, _, aux = _backbone(params, tokens, cfg=cfg, mode="train",
                          states=None, positions=None, page=None, qgen=qgen,
                          enc_out=enc_out, extra_embeds=extra)
    h = rmsnorm(params["final_norm"], h, eps=cfg.norm_eps)
    denom = torch.clamp_min(mask.sum(), 1.0) if loss_denom is None \
        else loss_denom
    nll_sum = _chunked_ce(params, h, labels, mask, cfg=cfg,
                          head_cfg=head_cfg,
                          chunk=min(h.shape[1], cfg.attn_chunk_size))
    loss = nll_sum / denom
    metrics = {"nll": loss.detach(),
               **{k: v.detach() for k, v in aux.items()}}
    for v in aux.values():
        loss = loss + v
    if loss_scale is not None:
        loss = loss * loss_scale.to(loss.dtype)
    return loss, metrics
