"""The attention-plus-FFN families the port runs beside qwen2 and the
paper's workloads, against `repro` on the CPU at smoke size: the dense
decoders codeqwen1.5-7b (MHA, qkv bias), internlm2-20b and
mistral-large-123b (GQA), llava-next-34b (a decoder behind the patch
stub's prefix, `extra_embeds`) and seamless-m4t-large-v2 (an
encoder-decoder behind the frame stub, `enc_inputs`, gelu; its vocabulary
padded to a multiple of 16), with the two MoE decoders where a test is
about every config:

  * each config's fields, full and smoke, are the reference's;
  * `from_jax_params` carries every leaf of the reference's (scanned)
    tree across, into the port's own layout;
  * the forward logits, and `lm_loss` and its gradients, at the
    reference's weights, on seeded batches (all-RNE hybrid formats at
    unit scales, both on their "xla" backends): within limits;
  * llava's `make_serve_prefill` with "extra_embeds": the logits and the
    cache (prefix and tokens) against the reference's; its calibration
    observes the prefix;
  * the recurrent families (ported) are served by the fixed-slot path
    and refused by paged serving, and the engines still refuse seamless
    (an encoder-decoder).

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

from repro.core.precision_policy import PrecisionPolicy, QuantConfig
from repro.models import transformer as jtr
from repro.models.registry import build_config as j_build_config
from repro.train.step import make_serve_prefill as j_make_serve_prefill
from repro_torch.core import precision_policy as tpp
from repro_torch.models import config as tmc
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import ARCHS, build_config
from repro_torch.optim.optimizers import tmap
from repro_torch.scaling.calibrate import calibrate, freeze
from repro_torch.serve.engine import (PagedServeConfig, PagedServeEngine,
                                      ServeConfig, ServeEngine)
from repro_torch.train.step import make_serve_chunk
from repro_torch.train.step import make_serve_prefill as t_make_serve_prefill

jax.config.update("jax_platform_name", "cpu")

PER_OP = {"xla_allow_excess_precision": False}
RNE = dict(act_rounding="rne", error_rounding="rne", grad_rounding="rne")
DENSE = ["codeqwen1.5-7b", "internlm2-20b", "mistral-large-123b",
         "llava-next-34b", "seamless-m4t-large-v2"]
NEW = DENSE + ["moonshot-v1-16b-a3b", "dbrx-132b"]
B, S = 2, 16
# Limits, set from readings on the CPU (all-RNE, unit scales): the logits'
# rel L2 read 0 (codeqwen) to 3.5e-5 (internlm2 and mistral-large, whose
# smoke configs are alike), the loss at most 7.6e-8 apart (relative), the
# gradients' rel L2 of all leaves together 0.143-0.180 (worst leaf 0.261,
# codeqwen's bk): the e5m2 chain turns last-bit differences into grid
# notches, as in tests/test_torch_seq2seq.py, whose GRAD_REL_L2 this
# shares.
LOGITS_REL_L2 = 1e-4
LOSS_REL = 1e-5
GRAD_REL_L2 = 0.35


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for this file (the suite runs
    in several worker processes on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def rel_l2(got, want) -> float:
    g, w = f32(got).astype(np.float64), f32(want).astype(np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def flat(t, path=""):
    if isinstance(t, dict):
        out = {}
        for k in t:
            out.update(flat(t[k], f"{path}/{k}"))
        return out
    return {path: t}


def grad_rel_l2(want, got) -> float:
    w = {k: f32(v).astype(np.float64) for k, v in flat(want).items()}
    g = {k: f32(v).astype(np.float64) for k, v in flat(got).items()}
    assert w.keys() == g.keys()
    num = sum(float(np.sum((w[k] - g[k]) ** 2)) for k in w)
    return float(np.sqrt(num / sum(float(np.sum(w[k] ** 2)) for k in w)))


def cfgs(arch):
    """(reference, port) smoke configs: the hybrid recipe's formats,
    all-RNE, unit scales, "xla" backends, no remat; the reference's
    layers scanned (its default)."""
    jq = QuantConfig(recipe="hybrid", backend="xla", **RNE)
    tq = tpp.QuantConfig(recipe="hybrid", backend="xla", **RNE)
    return (j_build_config(arch, smoke=True).replace(
                policy=PrecisionPolicy(quant=jq), remat=False),
            build_config(arch, smoke=True).replace(
                policy=tpp.PrecisionPolicy(quant=tq), remat=False))


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    """The reference's (scanned) smoke weights of `arch`, numpy leaves,
    drawn once for the file (one compile of its initializer)."""
    jcfg, _ = cfgs(arch)
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        jtr.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg))


def batch_for(cfg, seed=0):
    """Seeded tokens and labels (B, S); "extra_embeds" (B, P, D) for the
    patch stub, "enc_inputs" (B, S, D) for an encoder-decoder."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
               np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
               np.int32)}
    if cfg.frontend == "patch_stub":
        out["extra_embeds"] = rng.normal(
            size=(B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["enc_inputs"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    return out


@pytest.mark.parametrize("arch", NEW)
def test_config_matches_reference(arch):
    assert arch in ARCHS
    for smoke in (False, True):
        want = dataclasses.asdict(j_build_config(arch, smoke=smoke))
        got = dataclasses.asdict(build_config(arch, smoke=smoke))
        for f in ("policy",):
            want.pop(f), got.pop(f)
        assert got == want
        build_config(arch, smoke=smoke).check_ported()
    cfg = build_config(arch)
    if arch == "seamless-m4t-large-v2":
        assert (cfg.vocab_size, cfg.padded_vocab_size) == (256206, 256208)


@pytest.mark.parametrize("arch", NEW)
def test_from_jax_params_covers_every_leaf(arch):
    """The reference's scanned tree carried across: as many leaves as the
    reference's tree holds layers times leaves a layer, each the
    reference's slice bit for bit, in the keys and shapes of the port's
    own init_lm."""
    _, tcfg = cfgs(arch)
    jp = ref_params(arch)
    assert "stack_0" in jp["decoder"]
    tp = from_jax_params(jp, tcfg, device="cpu")
    n_ref = sum(int(np.prod(np.shape(x)[:1])) if "/stack_" in k else 1
                for k, x in flat(jp).items())
    assert len(flat(tp)) == n_ref
    for stack, n in (("decoder", tcfg.n_layers),
                     ("encoder", tcfg.n_encoder_layers)):
        for i in range(n):
            want = flat(jax.tree_util.tree_map(lambda x: x[i],
                                               jp[stack]["stack_0"]))
            got = flat(tp[stack][f"layer_{i}"])
            assert got.keys() == want.keys()
            for k, v in want.items():
                np.testing.assert_array_equal(f32(got[k]), v)
    own = ttr.init_lm(tcfg, device="cpu")
    assert tmap(lambda x: tuple(x.shape), tp) \
        == tmap(lambda x: tuple(x.shape), own)
    if tcfg.n_experts:
        assert set(tp["decoder"]["layer_0"]["moe"]) \
            == {"router", "w_gate", "w_up", "w_down"}


def ref_outputs(jcfg, jp, batch):
    """The reference's forward logits (with the prefix or the encoder
    output where the config has one), loss and gradients, one jit."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def run(p):
        enc_out = jtr.encode(p, jb["enc_inputs"], cfg=jcfg) \
            if jcfg.is_encoder_decoder else None
        logits, _, _ = jtr.forward(p, jb["tokens"], cfg=jcfg,
                                   extra_embeds=jb.get("extra_embeds"),
                                   enc_out=enc_out)
        (loss, _), grads = jax.value_and_grad(
            lambda q: jtr.lm_loss(q, jb, cfg=jcfg), has_aux=True)(p)
        return logits, loss, grads

    return jax.jit(run, compiler_options=PER_OP)(jp)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_lm_loss_match_reference(arch):
    jcfg, tcfg = cfgs(arch)
    jp = ref_params(arch)
    batch = batch_for(tcfg)
    logits_j, loss_j, grads_j = ref_outputs(
        jcfg, jax.tree_util.tree_map(jnp.asarray, jp), batch)
    tp = tmap(lambda x: x.requires_grad_(True),
              from_jax_params(jp, tcfg, device="cpu"))
    with torch.no_grad():
        enc_out = ttr.encode(tp, batch["enc_inputs"], cfg=tcfg) \
            if tcfg.is_encoder_decoder else None
        logits, _ = ttr.forward(tp, torch.from_numpy(batch["tokens"]),
                                cfg=tcfg, enc_out=enc_out,
                                extra_embeds=batch.get("extra_embeds"))
    loss, _ = ttr.lm_loss(tp, batch, cfg=tcfg)
    loss.backward()
    grads = tmap(lambda x: x.grad, tp)
    assert logits.shape == logits_j.shape
    assert rel_l2(logits, logits_j) <= LOGITS_REL_L2
    assert abs(loss.item() - float(loss_j)) <= LOSS_REL * abs(float(loss_j))
    want = from_jax_params(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), grads_j), tcfg, device="cpu")
    assert grad_rel_l2(want, grads) <= GRAD_REL_L2


def test_llava_prefill_with_extra_embeds_matches_reference():
    """make_serve_prefill with a batch's "extra_embeds" (the reference's
    passes them to its forward): the last position's logits and the cache
    of the P + S positions, against the reference's."""
    jcfg, tcfg = cfgs("llava-next-34b")
    jcfg = jcfg.replace(scan_layers=False)
    jp = jax.jit(jtr.init_lm, static_argnums=1)(jax.random.PRNGKey(2), jcfg)
    batch = batch_for(tcfg, seed=3)
    p_len = tcfg.n_frontend_tokens + S
    max_len = 64
    jst = jtr.init_stack_state(jcfg, B, max_len, n_layers=jcfg.n_layers)
    jl, jst = jax.jit(j_make_serve_prefill(jcfg), compiler_options=PER_OP)(
        jp, {"tokens": jnp.asarray(batch["tokens"]),
             "extra_embeds": jnp.asarray(batch["extra_embeds"])}, jst)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    tst = ttr.init_stack_state(tcfg, B, max_len, device="cpu")
    tl, tst = t_make_serve_prefill(tcfg)(
        tp, {"tokens": torch.from_numpy(batch["tokens"]).long(),
             "extra_embeds": torch.from_numpy(batch["extra_embeds"])}, tst)
    assert tl.shape == (B, 1, tcfg.padded_vocab_size)
    assert rel_l2(tl, jl) <= LOGITS_REL_L2
    for i in range(tcfg.n_layers):
        want = jst[f"layer_{i}"]["kv"]
        got = tst[f"layer_{i}"]["kv"]
        for name in ("k", "v"):
            assert rel_l2(got[name][:, :p_len], want[name][:, :p_len]) \
                <= LOGITS_REL_L2, (i, name)
        np.testing.assert_array_equal(np.asarray(got["length"]),
                                      np.asarray(want["length"]))
        assert int(np.asarray(want["length"])[0]) == p_len


def test_llava_calibration_observes_extra_embeds():
    """`calibrate` takes "extra_embeds" in a batch: the same sites as text
    alone, and the first layer's activation scales moved by the prefix."""
    _, tcfg = cfgs("llava-next-34b")
    params = ttr.init_lm(tcfg, device="cpu")
    batch = batch_for(tcfg, seed=4)
    text = [{"tokens": batch["tokens"]}]
    both = [{"tokens": batch["tokens"],
             "extra_embeds": batch["extra_embeds"]}]
    got = [freeze(*calibrate(params, tcfg, b)) for b in (text, both)]
    assert got[0].keys() == got[1].keys()
    key = "decoder/layer_0/attn/wq#a.A"
    assert got[0][key] != got[1][key]


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-125m"])
def test_recurrent_archs_still_refused(arch):
    """Both recurrent archs are ported: each config equals the
    reference's, the fixed-slot path takes it, and paged serving refuses
    its stack with the reference's ValueError."""
    ref = dataclasses.asdict(j_build_config(arch, smoke=True))
    ref.pop("policy")
    cfg = tmc.ModelConfig(**ref)
    assert build_config(arch, smoke=True) == cfg.replace(
        policy=build_config(arch, smoke=True).policy)
    cfg.check_ported(serving=True)
    ttr.init_stack_state(cfg, 2, 16, device="cpu")
    msg = "paged serving supports attention stacks only"
    with pytest.raises(ValueError, match=msg):
        cfg.check_ported(serving=True, paged=True)
    with pytest.raises(ValueError, match=msg):
        ttr.init_paged_stack_state(cfg, 64, device="cpu")
    with pytest.raises(ValueError, match=msg):
        jtr.init_paged_stack_state(j_build_config(arch, smoke=True), 64,
                                   n_layers=cfg.n_layers)


def test_engines_refuse_seamless():
    cfg = build_config("seamless-m4t-large-v2", smoke=True)
    cfg.check_ported()
    params = ttr.init_lm(cfg, device="cpu")
    for make in (lambda: ServeEngine(cfg, params, ServeConfig(),
                                     device="cpu"),
                 lambda: PagedServeEngine(cfg, params, PagedServeConfig(),
                                          device="cpu"),
                 lambda: ttr.init_paged_stack_state(cfg, 64, device="cpu"),
                 lambda: make_serve_chunk(cfg)):
        with pytest.raises(NotImplementedError, match="encoder-decoder"):
            make()
