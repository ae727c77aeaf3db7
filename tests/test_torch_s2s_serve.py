"""Serving the encoder-decoder in the port against `repro` on the CPU, on a
1 + 1 layer model (d_model 64, 4 heads of 16, vocab 64) with the
reference's weights carried over by `from_jax_params`:

  * the paper's recipe (unit scales; the port on its kernel backend, so
    the projections run kernel 5's plain version; the reference on its
    "xla" backend): `make_serve_prefill` (`encode`, then the causal
    prefill with cross-attention) and 8 greedy `make_serve_decode` steps
    fed the encoder output the caller computes, logits and tokens bit for
    bit;
  * the calibrated hybrid recipe (delayed scaling on the unfused path:
    the port with `fuse_epilogue=False, fuse_attention=False`, the
    reference on "xla"): calibration on batches with "enc_inputs" — the
    registry's keys in order, the encoder's and the cross-attention's
    sites among them, and the frozen scales and formats equal — then the
    same serving from the frozen scales, bit for bit;
  * the fused path (kernels 1 and 2's plain versions: 'full' at Q = 1 for
    the cross-attention decode, 'kv' at Q = 1 for the self-attention),
    calibrated and prefilled by the port: four decode steps from its
    caches, bit for bit against the reference's decode step on
    "pallas_interpret" (this file's one interpret compile) fed the same
    frozen scales, caches and encoder output; a planted fault (the
    cross-attention's K read at twice its scale) breaks the equality;
  * calibration without "enc_inputs" raises the reference's ValueError;
    the engines, paged serving and the launcher still refuse an
    encoder-decoder, as the reference's engines cannot serve one.

The reference runs with XLA's `xla_allow_excess_precision` off, as in
tests/test_torch_serve.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.precision_policy import PAPER_FP8, PrecisionPolicy
from repro.core.precision_policy import QuantConfig
from repro.models.config import ModelConfig
from repro.models.transformer import encode as j_encode
from repro.models.transformer import init_lm, init_stack_state
from repro.scaling.calibrate import calibrate, freeze_with_formats
from repro.scaling.state import ScalingConfig
from repro.train.step import _eval_cfg as j_eval_cfg
from repro.train.step import _maybe_frozen as j_maybe_frozen
from repro.train.step import make_serve_decode, make_serve_prefill
from repro_torch.core import precision_policy as tpp
from repro_torch.core import qattention as tqa
from repro_torch.data.pipeline import DataConfig, synthetic_seq2seq_batches
from repro_torch.models import config as tmc
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import from_jax_params
from repro_torch.scaling import calibrate as tcal
from repro_torch.scaling.state import ScalingConfig as TScalingConfig
from repro_torch.train import step as tstep

jax.config.update("jax_platform_name", "cpu")

PER_OP = {"xla_allow_excess_precision": False}
KW = dict(arch="t", n_layers=1, n_encoder_layers=1, d_model=64, n_heads=4,
          n_kv_heads=4, d_ff=128, vocab_size=64, max_seq_len=64,
          is_encoder_decoder=True, act="gelu")
B, SRC, PROMPT, NEW, MAX_LEN = 2, 12, 6, 8, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for this file (the suite runs
    in several worker processes on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batches(n=2):
    dc = DataConfig(vocab_size=64, seq_len=SRC, batch_size=B)
    return [b for _, b in zip(range(n), synthetic_seq2seq_batches(
        dc, d_model=64))]


def cfgs(recipe):
    """(reference, port) ModelConfigs: 'paper' — PAPER_FP8 at unit scales;
    'hybrid' — the hybrid recipe with delayed scaling, unfused."""
    if recipe == "paper":
        jq = dataclasses.replace(PAPER_FP8, backend="xla")
        tq = dataclasses.replace(tpp.PAPER_FP8, backend="pallas")
    else:
        jq = QuantConfig(recipe="hybrid", scaling="delayed", backend="xla")
        tq = tpp.QuantConfig(recipe="hybrid", scaling="delayed",
                             backend="pallas", fuse_epilogue=False,
                             fuse_attention=False)
    return (ModelConfig(policy=PrecisionPolicy(quant=jq), remat=False,
                        scan_layers=False, **KW),
            tmc.ModelConfig(policy=tpp.PrecisionPolicy(quant=tq), **KW))


def j_serve(cfg, params, frozen, batch):
    """The reference's prefill and NEW greedy decode steps: [logits]."""
    ecfg = j_eval_cfg(cfg, frozen)
    jit = functools.partial(jax.jit, compiler_options=PER_OP)
    prefill = jit(make_serve_prefill(cfg, frozen))
    decode = jit(make_serve_decode(cfg, frozen))

    def enc(p, x):
        with j_maybe_frozen(frozen):
            return j_encode(p, x, cfg=ecfg)

    x = jnp.asarray(batch["enc_inputs"])
    enc_out = jit(enc)(params, x)
    states = init_stack_state(cfg, B, MAX_LEN, n_layers=cfg.n_layers)
    logits, states = prefill(params, {"tokens": jnp.asarray(
        batch["tokens"][:, :PROMPT]), "enc_inputs": x}, states)
    out = [np.asarray(logits, np.float32)]
    for i in range(NEW):
        nxt = jnp.argmax(logits[:, -1, :cfg.vocab_size], -1)
        logits, states = decode(params, {
            "tokens": nxt[:, None].astype(jnp.int32),
            "positions": jnp.full((B, 1), PROMPT + i, jnp.int32),
            "enc_out": enc_out}, states)
        out.append(np.asarray(logits, np.float32))
    return out


def t_serve(cfg, params, frozen, batch):
    """The port's prefill and NEW greedy decode steps: [logits]."""
    ecfg = tstep._eval_cfg(cfg, frozen)
    prefill = tstep.make_serve_prefill(cfg, frozen)
    decode = tstep.make_serve_decode(cfg, frozen)
    with torch.no_grad(), tstep._maybe_frozen(frozen):
        enc_out = ttr.encode(params, batch["enc_inputs"], cfg=ecfg)
    states = ttr.init_stack_state(cfg, B, MAX_LEN, device="cpu")
    logits, states = prefill(params, {"tokens": torch.from_numpy(
        batch["tokens"][:, :PROMPT]).long(),
        "enc_inputs": batch["enc_inputs"]}, states)
    out = [logits.float().numpy()]
    for i in range(NEW):
        nxt = logits[:, -1, :cfg.vocab_size].argmax(-1)
        logits, states = decode(params, {
            "tokens": nxt[:, None],
            "positions": torch.full((B, 1), PROMPT + i),
            "enc_out": enc_out}, states)
        out.append(logits.float().numpy())
    return out


def greedy(logits_list, vocab=64):
    return np.stack([lg[:, -1, :vocab].argmax(-1)
                     for lg in logits_list[:-1]], 1)


@pytest.fixture(scope="module", params=["paper", "hybrid"])
def served(request):
    """Both packages at the reference's weights: calibrated and frozen
    (hybrid), then served."""
    jcfg, tcfg = cfgs(request.param)
    params = jax.jit(init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, device="cpu")
    bs = batches()
    out = dict(recipe=request.param, jcfg=jcfg, tcfg=tcfg, tparams=tparams)
    frozen = tfrozen = None
    if request.param == "hybrid":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "jit", functools.partial(
                jax.jit, compiler_options=PER_OP))
            ds, state = calibrate(params, jcfg, [
                {k: jnp.asarray(v) for k, v in b.items()} for b in bs],
                scaling_cfg=ScalingConfig(margin=1.0))
        frozen, formats = freeze_with_formats(ds, state, jcfg)
        tds, tstate = tcal.calibrate(tparams, tcfg, bs,
                                     scaling_cfg=TScalingConfig(margin=1.0))
        tfrozen, tformats = tcal.freeze_with_formats(tds, tstate, tcfg)
        out.update(keys=ds.registry.keys, tkeys=tds.registry.keys,
                   frozen=frozen, tfrozen=tfrozen, formats=formats,
                   tformats=tformats)
    out["want"] = j_serve(jcfg, params, frozen, bs[0])
    out["got"] = t_serve(tcfg, tparams, tfrozen, bs[0])
    return out


def test_prefill_and_decode_match_reference(served):
    """Prefill logits, then NEW decode steps' logits and greedy tokens,
    bit for bit."""
    want, got = served["want"], served["got"]
    assert len(got) == len(want) == NEW + 1
    assert got[0].shape == (B, 1, 64)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"step {i}")
    assert np.array_equal(greedy(got), greedy(want))


@pytest.mark.parametrize("served", ["hybrid"], indirect=True)
def test_calibration_matches_reference(served):
    keys = served["tkeys"]
    assert keys == served["keys"]
    for k in ("encoder/layer_0/attn/qk#a.A", "encoder/layer_0/attn/wq#b.W",
              "decoder/layer_0/cross_attn/pv#b.A",
              "decoder/layer_0/cross_attn/wk#a.A"):
        assert k in keys, k
    assert served["tfrozen"] == served["frozen"]
    assert served["tformats"] == served["formats"]


def test_calibration_needs_enc_inputs(served):
    batch = batches(1)[0]
    with pytest.raises(ValueError, match="enc_inputs"):
        tcal.calibrate(served["tparams"], served["tcfg"],
                       [{"tokens": batch["tokens"]}])


# ---------------------------------------------------------------------------
# the fused path (kernels 1 and 2's plain versions)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fused_decode():
    """The fused path calibrated by the port (its registry's keys are the
    reference's) and prefilled; the reference's decode step compiled once
    on "pallas_interpret" with those frozen scales, and the caches, the
    encoder output and the greedy tokens to feed both packages."""
    jcfg, tcfg = cfgs("hybrid")
    jq = QuantConfig(recipe="hybrid", scaling="delayed",
                     backend="pallas_interpret")
    jcfg = jcfg.replace(policy=PrecisionPolicy(quant=jq))
    tcfg = tcfg.replace(policy=tpp.PrecisionPolicy(quant=tpp.QuantConfig(
        recipe="hybrid", scaling="delayed", backend="pallas")))
    params = jax.jit(init_lm, static_argnums=1)(jax.random.PRNGKey(1), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, device="cpu")
    bs = batches()
    tds, tstate = tcal.calibrate(tparams, tcfg, bs,
                                 scaling_cfg=TScalingConfig(margin=1.0))
    frozen = tcal.freeze(tds, tstate)
    prefill = tstep.make_serve_prefill(tcfg, frozen)
    states = ttr.init_stack_state(tcfg, B, MAX_LEN, device="cpu")
    logits, states = prefill(tparams, {"tokens": torch.from_numpy(
        bs[0]["tokens"][:, :PROMPT]).long(),
        "enc_inputs": bs[0]["enc_inputs"]}, states)
    with torch.no_grad(), tstep._maybe_frozen(frozen):
        enc_out = ttr.encode(tparams, bs[0]["enc_inputs"],
                             cfg=tstep._eval_cfg(tcfg, frozen))
    decode = jax.jit(make_serve_decode(jcfg, frozen),
                     compiler_options=PER_OP)
    return dict(tcfg=tcfg, tparams=tparams, params=params, frozen=frozen,
                states=states, enc_out=enc_out, decode=decode,
                first=logits[:, -1, :64].argmax(-1))


def j_tree(t):
    if isinstance(t, dict):
        return {k: j_tree(v) for k, v in t.items()}
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def decode_pair(s, steps=4):
    """`steps` decode steps of both packages from the port's prefilled
    caches, fed the port's greedy tokens: [(port, reference) logits]."""
    decode = tstep.make_serve_decode(s["tcfg"], s["frozen"])
    states = {n: {"kv": {k: v.clone() for k, v in st["kv"].items()}}
              for n, st in s["states"].items()}
    jstates = j_tree(states)
    jenc = jnp.asarray(s["enc_out"].float().numpy(), jnp.bfloat16)
    nxt, out = s["first"], []
    for i in range(steps):
        pos = torch.full((B, 1), PROMPT + i)
        logits, states = decode(s["tparams"], {
            "tokens": nxt[:, None], "positions": pos,
            "enc_out": s["enc_out"]}, states)
        jlogits, jstates = s["decode"](s["params"], {
            "tokens": jnp.asarray(nxt[:, None].numpy(), jnp.int32),
            "positions": jnp.asarray(pos.numpy(), jnp.int32),
            "enc_out": jenc}, jstates)
        out.append((logits.float().numpy(), np.asarray(jlogits, np.float32)))
        nxt = logits[:, -1, :64].argmax(-1)
    return out


def test_fused_decode_matches_reference(fused_decode, monkeypatch):
    """The cross-attention's decode through kernel 2's 'full' mask at
    Q = 1 and the self-attention's through its 'kv' mask at Q = 1: logits
    bit for bit against the reference's Pallas kernels (interpret mode)."""
    from repro_torch.kernels.fp8_attention import ops as attn_ops
    masks = []
    orig = attn_ops.fp8_attention_fwd

    def spy(q, k, v, *a, **kw):
        masks.append((kw.get("mask_mode"), q.shape[2]))
        return orig(q, k, v, *a, **kw)
    monkeypatch.setattr(attn_ops, "fp8_attention_fwd", spy)
    for i, (got, want) in enumerate(decode_pair(fused_decode)):
        np.testing.assert_array_equal(got, want, err_msg=f"step {i}")
    assert ("full", 1) in masks and ("kv", 1) in masks


def test_fused_decode_planted_fault_breaks_equality(fused_decode,
                                                    monkeypatch):
    """The cross-attention reading its K at twice its scale."""
    orig = tqa._fwd_factors

    def k_twice(s_q, s_k, s_v, s_s, s_p, sm_scale):
        return orig(s_q, np.float32(2) * np.float32(s_k), s_v, s_s, s_p,
                    sm_scale)
    orig_sdpa = tqa.fp8_sdpa

    def cross_k_twice(q, k, v, **kw):
        if kw.get("mask_mode") == "full" and q.shape[2] != k.shape[2]:
            with monkeypatch.context() as mp:
                mp.setattr(tqa, "_fwd_factors", k_twice)
                return orig_sdpa(q, k, v, **kw)
        return orig_sdpa(q, k, v, **kw)
    from repro_torch.models import attention as tattn
    monkeypatch.setattr(tattn, "fp8_sdpa", cross_k_twice)
    pairs = decode_pair(fused_decode, steps=1)
    assert not np.array_equal(*pairs[0])


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_engines_still_refuse_an_encoder_decoder():
    from repro_torch.launch import serve as tlaunch
    from repro_torch.serve.engine import (PagedServeConfig,
                                          PagedServeEngine, ServeConfig,
                                          ServeEngine)
    _, tcfg = cfgs("paper")
    params = ttr.init_lm(tcfg, device="cpu")
    for make in (
            lambda: ServeEngine(tcfg, params, ServeConfig(max_batch=2,
                                                          max_len=32),
                                device="cpu"),
            lambda: PagedServeEngine(tcfg, params, PagedServeConfig(
                max_batch=2, max_len=32, n_pages=8, page_size=4),
                device="cpu"),
            lambda: ttr.init_paged_stack_state(tcfg, 32, device="cpu"),
            lambda: tstep.make_serve_chunk(tcfg),
            lambda: tlaunch.main(["--arch", "paper-transformer", "--smoke",
                                  "--device", "cpu"])):
        with pytest.raises(NotImplementedError, match="encoder-decoder"):
            make()
    # The fixed-slot caches of the decoder's self-attention only.
    states = ttr.init_stack_state(tcfg, 2, 32, device="cpu")
    assert list(states) == ["layer_0"] and list(states["layer_0"]) == ["kv"]
