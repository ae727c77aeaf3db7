"""The training step's single-device options in the port against `repro` on
the CPU, on a 2-layer GQA decoder (d_model 64, heads 4/2, vocab 64) with
the reference's weights carried over by `from_jax_params`:

  * delayed scaling on the unfused path (the hybrid recipe, all-RNE, the
    port with `fuse_epilogue=False, fuse_attention=False` on its kernel
    backend, so the projections run kernel 5's plain version; the
    reference on its "xla" backend): the site registry in order, the
    loss and the gradients under `collect()` of the reference's ScaleState
    after one step, and the ScaleState after the port's own step, within
    limits which two sites' scales traded exceed;
  * just-in-time amax scaling: `amax_scale` and
    `quantize(use_amax_scale=True)` bit for bit (bf16 and f32, both
    formats, RNE, and SR given the reference's bits), `amax_for` and its
    deprecated shims, and one all-RNE step within the step limits, which a
    planted kernel-5 fault exceeds;
  * the "most_recent" and "ema" history policies: `DelayedScaling.update`
    bit for bit against the reference's on histories partly populated and
    full (its update run op by op, as its calibration runs it; inside its
    jitted training step XLA contracts the ema's weighted sums into fused
    multiply-adds and divides by the formats' maxima as a multiply by
    their reciprocals, an f32 ulp or a few apart, as
    tests/test_torch_train_step.py notes for the "max" policy);
  * recomputation (`remat=True`): two steps equal the same steps without
    it bit for bit — loss, gradients, master weights, ScaleState and
    health pairs — under the hybrid delayed recipe with SR (fused path,
    and the encoder-decoder), the paper's recipe, and the chunked
    attention above `attn_chunk_threshold`; the recomputation drawing its
    SR bits from the step's own generator, or forgetting its scope path,
    breaks the equality.

The reference runs with XLA's `xla_allow_excess_precision` off, as in
tests/test_torch_serve.py.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.core.fp8_formats import get_format as j_format
from repro.core.precision_policy import PrecisionPolicy, QuantConfig
from repro.models.config import ModelConfig
from repro.models.transformer import init_lm, lm_loss
from repro.scaling import DelayedScaling, discover_lm_sites
from repro.scaling.state import ScalingConfig as JScalingConfig
from repro.scaling.state import SiteRegistry as JSiteRegistry
from repro.train.step import make_optimizer_for, make_train_step
from repro_torch.core import precision_policy as tpp
from repro_torch.core import quantize as tq
from repro_torch.core.fp8_formats import get_format as t_format
from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
from repro_torch.data.pipeline import synthetic_seq2seq_batches
from repro_torch.kernels.fp8_matmul import ops as tmm
from repro_torch.models import config as tmc
from repro_torch.models import remat as tremat
from repro_torch.models.convert import from_jax_params
from repro_torch.models.transformer import init_lm as t_init_lm
from repro_torch.models.transformer import lm_loss as t_lm_loss
from repro_torch.optim.optimizers import tmap
from repro_torch.scaling import context as tsc
from repro_torch.scaling.calibrate import discover_lm_sites as t_discover
from repro_torch.scaling.state import DelayedScaling as TDelayedScaling
from repro_torch.scaling.state import ScaleState as TScaleState
from repro_torch.scaling.state import ScalingConfig as TScalingConfig
from repro_torch.scaling.state import SiteRegistry as TSiteRegistry
from repro_torch.train.step import make_optimizer_for as t_make_optimizer_for
from repro_torch.train.step import make_train_step as t_make_train_step

jax.config.update("jax_platform_name", "cpu")

PER_OP = {"xla_allow_excess_precision": False}
RNE = dict(act_rounding="rne", error_rounding="rne", grad_rounding="rne")
KW = dict(arch="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          d_ff=128, vocab_size=64, max_seq_len=64)
# Limits: those of the existing step tests (tests/test_torch_train_step.py
# and tests/test_torch_seq2seq.py): the loss of a delayed step (rel),
# the gradients of all leaves together (rel L2), a scale one grid notch
# from the reference's; the unfused step's loss and gradients
# (tests/test_torch_unfused.py).
DELAYED_LOSS_REL = 1e-5
GRAD_REL_L2 = 0.35
LOSS_REL = 1e-2
STEP_GRAD_REL_L2 = 0.3
FMTS = ("e4m3", "e5m2")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for this file (the suite runs
    in several worker processes on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def per_op(fn):
    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "jit", functools.partial(jax.jit,
                                                     compiler_options=PER_OP))
            return fn(*a, **kw)
    return wrapped


def flat(t, path=""):
    if isinstance(t, dict):
        out = {}
        for k in t:
            out.update(flat(t[k], f"{path}/{k}"))
        return out
    if isinstance(t, torch.Tensor):
        return {path: t.detach().float().numpy()}
    return {path: np.asarray(t, np.float32)}


def grad_rel_l2(want, got) -> float:
    w, g = flat(want), flat(got)
    assert w.keys() == g.keys()
    num = sum(float(np.sum((w[k].astype(np.float64) - g[k]) ** 2))
              for k in w)
    return float(np.sqrt(num / sum(float(np.sum(w[k].astype(np.float64)
                                                ** 2)) for k in w)))


def lm_batch(seq_len=32, batch_size=2):
    return next(synthetic_lm_batches(DataConfig(
        vocab_size=64, seq_len=seq_len, batch_size=batch_size)))


def one_notch(a, b, man) -> bool:
    a, b = np.float32(a), np.float32(b)
    if a == b:
        return True
    lo, hi = sorted((float(a), float(b)))
    return lo > 0 and hi / lo <= 1 + 2.0 ** -man + 1e-6


# ---------------------------------------------------------------------------
# delayed scaling on the unfused path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unfused_delayed():
    """The reference's hybrid delayed step on its "xla" backend (all-RNE):
    its registry, the ScaleState and metrics after one step, and its
    scaled loss and gradients under collect() of that state."""
    jq_ = QuantConfig(recipe="hybrid", scaling="delayed", backend="xla",
                      **RNE)
    tq_ = tpp.QuantConfig(recipe="hybrid", scaling="delayed",
                          backend="pallas", fuse_epilogue=False,
                          fuse_attention=False, **RNE)
    jcfg = ModelConfig(policy=PrecisionPolicy(quant=jq_), remat=False,
                       scan_layers=False, **KW)
    tcfg = tmc.ModelConfig(policy=tpp.PrecisionPolicy(quant=tq_),
                           remat=False, **KW)
    jp = init_lm(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    batch = lm_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @per_op
    def reference():
        reg = discover_lm_sites(jcfg, jp, jb)
        ds = DelayedScaling(reg, qcfg=jcfg.policy.quant)
        opt = make_optimizer_for(jcfg, learning_rate=1e-3)
        st = opt.init(jp)
        (_, ss1), met = jax.jit(make_train_step(jcfg, opt, scaling=ds))(
            st, ds.init(), jb, jax.random.PRNGKey(0))

        def loss_fn(params, tokens, scale_state):
            with ds.collect(scale_state, tokens):
                return lm_loss(params, jb, cfg=jcfg,
                               qkey=jax.random.PRNGKey(0),
                               loss_scale=st.loss_scale.scale)
        (loss, _), (grads, _) = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True))(
                opt.compute_params(st), ds.zero_tokens(), ss1)
        return reg, ss1, met, float(loss), grads

    reg, ss1, met, loss, grads = reference()
    return dict(tcfg=tcfg, tp=tp, batch=batch, reg=reg,
                ss1=TScaleState(amax_history=np.asarray(ss1.amax_history),
                                scale=np.asarray(ss1.scale), step=1),
                met=met, loss=loss,
                grads=jax.tree_util.tree_map(np.asarray, grads))


def delayed_loss_grads(s, scale):
    """The port's scaled loss and gradients under collect() of the
    reference's ScaleState with the site scales `scale`."""
    tcfg = s["tcfg"]
    ds = TDelayedScaling(t_discover(tcfg, s["tp"], s["batch"]),
                         qcfg=tcfg.policy.quant)
    opt = t_make_optimizer_for(tcfg, learning_rate=1e-3)
    st = opt.init(s["tp"])
    params = tmap(lambda p: p.requires_grad_(True), opt.compute_params(st))
    ss = TScaleState(amax_history=s["ss1"].amax_history, scale=scale,
                     step=1)
    with ds.collect(ss):
        loss, _ = t_lm_loss(params, s["batch"], cfg=tcfg,
                            qgen=torch.Generator().manual_seed(0),
                            loss_scale=st.loss_scale.scale)
        loss.backward()
    return loss.item(), tmap(lambda p: p.grad.float().numpy(), params)


def test_unfused_delayed_registry_matches_reference(unfused_delayed):
    """The unfused sites: the projections' #a / #b / #E / #G and the
    attention's qk / pv (#a.A, #b.A, #E), no fused-output sites."""
    s = unfused_delayed
    reg = t_discover(s["tcfg"], s["tp"], s["batch"])
    assert reg.keys == s["reg"].keys
    assert reg.token_sites == s["reg"].token_sites
    assert "decoder/layer_1/attn/qk#b.A" in reg.keys
    assert not any(k.endswith(("#y.A", "#da.E")) for k in reg.keys)
    assert "decoder/layer_0/attn/pv#G" not in reg.keys


def test_unfused_delayed_loss_and_grads_within_limit(unfused_delayed):
    s = unfused_delayed
    loss, grads = delayed_loss_grads(s, s["ss1"].scale)
    assert abs(loss - s["loss"]) <= DELAYED_LOSS_REL * abs(s["loss"])
    rel = grad_rel_l2(s["grads"], grads)
    assert rel <= GRAD_REL_L2, rel


# Read: the loss bitwise equal, the gradients 0.142; with SWAP traded the
# loss 1.3e-3 apart and the gradients 0.556.
SWAP = ("decoder/layer_1/attn/wo#a.A", "decoder/layer_1/attn/wo#b.W")


def test_unfused_delayed_swapped_scales_exceed_limit(unfused_delayed):
    """Two sites' scales traded (the output projection's activation and
    weight operands) must read above the limits."""
    s = unfused_delayed
    keys = list(s["reg"].keys)
    i, j = (keys.index(k) for k in SWAP)
    scale = s["ss1"].scale.copy()
    scale[i], scale[j] = scale[j], scale[i]
    assert scale[i] != scale[j]
    loss, grads = delayed_loss_grads(s, scale)
    rel = grad_rel_l2(s["grads"], grads)
    assert not rel <= GRAD_REL_L2, rel
    assert abs(loss - s["loss"]) > DELAYED_LOSS_REL * abs(s["loss"])


def test_unfused_delayed_scale_state_within_one_notch(unfused_delayed):
    s = unfused_delayed
    tcfg = s["tcfg"]
    reg = t_discover(tcfg, s["tp"], s["batch"])
    ds = TDelayedScaling(reg, qcfg=tcfg.policy.quant)
    opt = t_make_optimizer_for(tcfg, learning_rate=1e-3)
    step = t_make_train_step(tcfg, opt, scaling=ds, device="cpu")
    (_, ss1), met = step(opt.init(s["tp"]), ds.init(), s["batch"],
                         torch.Generator().manual_seed(0))
    assert met["grads_finite"] and met["loss_scale"] == float(
        s["met"]["loss_scale"])
    want = s["ss1"].scale
    for i, key in enumerate(reg.keys):
        man = 3 if reg.class_letter(key) in ("W", "A") else 2
        assert one_notch(want[i], ss1.scale[i], man), (key, want[i],
                                                       ss1.scale[i])


# ---------------------------------------------------------------------------
# just-in-time amax scaling
# ---------------------------------------------------------------------------

def payload_bits(x):
    """uint8 patterns of an fp8 payload, every NaN as 0xFF."""
    if isinstance(x, torch.Tensor):
        u, nan = x.view(torch.uint8).numpy().copy(), \
            torch.isnan(x.float()).numpy()
    else:
        a = np.asarray(x)
        u, nan = a.view(np.uint8).copy(), np.isnan(a.astype(np.float32))
    u[nan] = 0xFF
    return u


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rounding", ["rne", "sr"])
def test_jit_amax_quantize_bitwise(fmt, dtype, rounding):
    """amax_scale, then x * (1/scale) in x's dtype, then RNE or SR with the
    reference's bits; the scale a 0-d f32 tensor, and the dequantize."""
    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(5)
    for lo, hi in ((-12.0, 12.0), (-30.0, -20.0), (5.0, 30.0)):
        mag = np.exp2(rng.uniform(lo, hi, (48, 40)))
        x = (mag * rng.choice([-1.0, 1.0], mag.shape)).astype(np.float32)
        j_in = jnp.asarray(x).astype(getattr(jnp, dtype))
        t_in = torch.from_numpy(np.array(j_in.astype(jnp.float32))).to(
            getattr(torch, dtype))
        js = jq.amax_scale(j_in, j_format(fmt))
        ts = tq.amax_scale(t_in, t_format(fmt))
        assert ts.dtype == torch.float32 and ts.dim() == 0
        assert np.float32(js) == np.float32(ts.item())
        jqt = jq.quantize(j_in, fmt, rounding=rounding, key=key,
                          use_amax_scale=True)
        rand = None if rounding == "rne" else torch.from_numpy(np.asarray(
            jax.random.bits(key, x.shape, jnp.uint16)).astype(np.int32))
        tqt = tq.quantize(t_in, fmt, rounding=rounding, rand=rand,
                          use_amax_scale=True)
        assert isinstance(tqt.scale, torch.Tensor)
        np.testing.assert_array_equal(payload_bits(jqt.data),
                                      payload_bits(tqt.data))
        for dt in ("float32", "bfloat16"):
            jd = np.asarray(jq.dequantize(jqt, getattr(jnp, dt)).astype(
                jnp.float32))
            td = tq.dequantize(tqt, getattr(torch, dt)).float().numpy()
            np.testing.assert_array_equal(jd, td)


def test_amax_for_and_shims_match_reference():
    for kw in (dict(scaling="jit_amax"), dict(amax_scale_fwd=True),
               dict(amax_scale_bwd=True), dict(scaling="delayed"), {}):
        j, t = QuantConfig(**kw), tpp.QuantConfig(**kw)
        assert j.scaling == t.scaling
        for cls in ("weight", "act", "error", "grad"):
            assert j.amax_for(cls) == t.amax_for(cls), (kw, cls)


@pytest.fixture(scope="module")
def jit_amax_step():
    """The reference's all-RNE hybrid jit_amax step ("xla" backend) and
    its gradients at the initial weights; the port's pieces (kernel
    backend: kernel 5's plain version)."""
    jq_ = QuantConfig(recipe="hybrid", scaling="jit_amax", backend="xla",
                      **RNE)
    tq_ = tpp.QuantConfig(recipe="hybrid", scaling="jit_amax",
                          backend="pallas", **RNE)
    jcfg = ModelConfig(policy=PrecisionPolicy(quant=jq_), remat=False,
                       scan_layers=False, **KW)
    tcfg = tmc.ModelConfig(policy=tpp.PrecisionPolicy(quant=tq_),
                           remat=False, **KW)
    jp = init_lm(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    batch = lm_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @per_op
    def reference():
        opt = make_optimizer_for(jcfg, learning_rate=1e-3)
        st = opt.init(jp)
        _, met = jax.jit(make_train_step(jcfg, opt))(st, jb,
                                                     jax.random.PRNGKey(0))
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: lm_loss(p, jb, cfg=jcfg, qkey=jax.random.PRNGKey(0),
                              loss_scale=st.loss_scale.scale),
            has_aux=True))(opt.compute_params(st))
        return met, float(loss), grads

    met, loss, grads = reference()
    return dict(tcfg=tcfg, tp=tp, batch=batch, met=met, loss=loss,
                grads=jax.tree_util.tree_map(np.asarray, grads))


def jit_amax_loss_grads(s):
    opt = t_make_optimizer_for(s["tcfg"], learning_rate=1e-3)
    st = opt.init(s["tp"])
    params = tmap(lambda p: p.requires_grad_(True), opt.compute_params(st))
    loss, _ = t_lm_loss(params, s["batch"], cfg=s["tcfg"],
                        loss_scale=st.loss_scale.scale)
    loss.backward()
    return loss.item(), tmap(lambda p: p.grad, params)


def test_jit_amax_step_within_limit(jit_amax_step):
    s = jit_amax_step
    opt = t_make_optimizer_for(s["tcfg"], learning_rate=1e-3)
    step = t_make_train_step(s["tcfg"], opt, device="cpu")
    _, met = step(opt.init(s["tp"]), s["batch"],
                  torch.Generator().manual_seed(0))
    want = {k: float(v) for k, v in s["met"].items() if np.ndim(v) == 0}
    assert met["grads_finite"] and want["grads_finite"]
    assert met["loss_scale"] == want["loss_scale"]
    assert abs(met["loss"] - want["loss"]) <= LOSS_REL * abs(want["loss"])
    assert abs(met["grad_norm"] - want["grad_norm"]) \
        <= STEP_GRAD_REL_L2 * want["grad_norm"]
    loss, grads = jit_amax_loss_grads(s)
    assert abs(loss - s["loss"]) <= LOSS_REL * abs(s["loss"])
    rel = grad_rel_l2(s["grads"], grads)
    assert rel <= STEP_GRAD_REL_L2, rel


def test_jit_amax_step_planted_fault_exceeds_limit(jit_amax_step,
                                                   monkeypatch):
    """The fp8 GEMM with its last 64-wide K block dropped (a kernel-5
    fault) must read above the step's gradient limit."""
    orig = tmm.fp8_matmul

    def drop_last_k(a, b, out_dtype=torch.float32):
        k = a.shape[1] - 64
        return orig(a[:, :k].contiguous(), b[:k].contiguous(), out_dtype)
    monkeypatch.setattr(tmm, "fp8_matmul", drop_last_k)
    _, grads = jit_amax_loss_grads(jit_amax_step)
    rel = grad_rel_l2(jit_amax_step["grads"], grads)
    assert not rel <= STEP_GRAD_REL_L2, rel


def test_jit_amax_scales_stay_on_the_device(monkeypatch):
    """No Q node of a jit_amax forward and backward reads a scale on the
    host: the scales reach the GEMM and the dequantize as 0-d tensors, and
    nothing calls float() or item() on a tensor (a device->host read on
    the card)."""
    from repro_torch.core import qlinear as tql
    tcfg = tmc.ModelConfig(policy=tpp.PrecisionPolicy(
        quant=tpp.QuantConfig(recipe="hybrid", scaling="jit_amax",
                              backend="pallas")), remat=False, **KW)
    params = tmap(lambda p: p.requires_grad_(True),
                  t_init_lm(tcfg, device="cpu"))
    scales = []
    orig = tql._compute

    def spy(spec, qa, qb, cfg):
        scales.extend((qa.scale, qb.scale))
        return orig(spec, qa, qb, cfg)

    def host_read(*a):
        raise AssertionError("a tensor was read on the host")
    monkeypatch.setattr(tql, "_compute", spy)
    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "item", host_read)
        mp.setattr(torch.Tensor, "__float__", host_read)
        loss, _ = t_lm_loss(params, lm_batch(), cfg=tcfg,
                            qgen=torch.Generator().manual_seed(0))
        loss.backward()
    assert scales and all(isinstance(x, torch.Tensor) and x.dim() == 0
               for x in scales)


# ---------------------------------------------------------------------------
# history policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["most_recent", "ema"])
@pytest.mark.parametrize("history_len", [4, 16])
def test_history_policy_update_bitwise(policy, history_len):
    """Eight updates from a fresh state (partly populated histories, then
    full ones once history_len steps have passed), with unobserved sites,
    a saturation probe and an overflow: history and scales bit for bit
    against the reference's update, and the frozen scales equal."""
    keys = ["l/a#a.A", "l/a#b.W", "l/a#E", "l/a#G", "l/s#qk.A"]
    jcfg = QuantConfig(recipe="hybrid", scaling="delayed")
    tcfg = tpp.QuantConfig(recipe="hybrid", scaling="delayed")
    kw = dict(history_len=history_len, policy=policy)
    jds = DelayedScaling(JSiteRegistry(keys), JScalingConfig(**kw), jcfg)
    tds = TDelayedScaling(TSiteRegistry(keys), TScalingConfig(**kw), tcfg)
    js, ts = jds.init(), tds.init()
    rng = np.random.default_rng(11)
    for step in range(max(8, history_len + 3)):
        obs = {k: np.float32(np.exp2(rng.uniform(-10, 12)))
               for k in keys if rng.random() < 0.8}
        if step == 3:
            cap = np.asarray(js.scale) * jds.registry.fmt_max_vector(jcfg)
            obs[keys[0]] = np.float32(cap[0])
            obs[keys[2]] = np.float32(np.inf)
        js = jds.update(js, {k: jnp.float32(v) for k, v in obs.items()})
        ts = tds.update(ts, obs)
        np.testing.assert_array_equal(np.asarray(js.amax_history),
                                      ts.amax_history)
        np.testing.assert_array_equal(np.asarray(js.scale), ts.scale)
    assert np.all(ts.amax_history > 0)      # full by now
    assert jds.freeze(js) == tds.freeze(ts)


def test_ema_weights_over_the_populated_prefix():
    """A row with one observation reads that observation under "ema";
    "max" keeps its default (and the step's state layout)."""
    assert TScalingConfig().policy == "max" and \
        TScalingConfig().ema_decay == 0.75
    from repro_torch.scaling.state import amax_from_history
    hist = np.zeros((2, 16), np.float32)
    hist[0, 0] = 3.0
    hist[1] = 2.0
    got = amax_from_history(hist, TScalingConfig(policy="ema"))
    np.testing.assert_array_equal(got, np.float32([3.0, 2.0]))
    with pytest.raises(ValueError, match="policy"):
        amax_from_history(hist, TScalingConfig(policy="median"))


# ---------------------------------------------------------------------------
# recomputation (remat)
# ---------------------------------------------------------------------------

REMAT_CASES = {
    "hybrid_delayed_sr": dict(quant=dict(recipe="hybrid",
                                         scaling="delayed"), health=True),
    "paper_sr": dict(quant=dict()),
    "chunked_unfused_delayed_sr": dict(
        quant=dict(recipe="hybrid", scaling="delayed",
                   fuse_attention=False),
        model=dict(attn_chunk_threshold=8, attn_chunk_size=8)),
    "encoder_decoder_hybrid_delayed_sr": dict(
        quant=dict(recipe="hybrid", scaling="delayed"),
        model=dict(is_encoder_decoder=True, n_encoder_layers=2,
                   n_kv_heads=4, act="gelu")),
}


def remat_cfg(case, remat):
    c = REMAT_CASES[case]
    q = tpp.QuantConfig(backend="pallas", track_health=c.get("health",
                                                             False),
                        **c["quant"])
    return tmc.ModelConfig(policy=tpp.PrecisionPolicy(quant=q), remat=remat,
                           **{**KW, **c.get("model", {})})


def remat_batch(cfg):
    dc = DataConfig(vocab_size=64, seq_len=24, batch_size=2)
    if cfg.is_encoder_decoder:
        return next(synthetic_seq2seq_batches(dc, d_model=cfg.d_model))
    return next(synthetic_lm_batches(dc))


def remat_run(case, remat):
    """Two steps (seeded weights, the generator seeded) and the gradients
    of a third loss under the resulting state: (metrics, master weights,
    ScaleState or None, gradients)."""
    cfg = remat_cfg(case, remat)
    params = t_init_lm(cfg, seed=3, device="cpu")
    batch = remat_batch(cfg)
    opt = t_make_optimizer_for(cfg, learning_rate=1e-2)
    gen = torch.Generator().manual_seed(7)
    st = opt.init(params)
    ds = ss = None
    if cfg.policy.quant.delayed:
        ds = TDelayedScaling(t_discover(cfg, params, batch),
                             qcfg=cfg.policy.quant)
        ss = ds.init()
        step = t_make_train_step(cfg, opt, scaling=ds, device="cpu")
    else:
        step = t_make_train_step(cfg, opt, device="cpu")
    mets = []
    for _ in range(2):
        if ds is None:
            st, m = step(st, batch, gen)
        else:
            (st, ss), m = step(st, ss, batch, gen)
        mets.append(m)
    p = tmap(lambda x: x.requires_grad_(True), opt.compute_params(st))
    with ds.collect(ss) if ds is not None else contextlib.nullcontext():
        loss, _ = t_lm_loss(p, batch, cfg=cfg, qgen=gen,
                            loss_scale=st.loss_scale.scale)
        loss.backward()
    return mets, flat(st.master), ss, flat(tmap(lambda x: x.grad, p))


def assert_runs_equal(a, b):
    (ma, wa, sa, ga), (mb, wb, sb, gb) = a, b
    for x, y in zip(ma, mb):
        assert x.keys() == y.keys()
        for k in x:     # NaN where the other is NaN
            np.testing.assert_array_equal(np.asarray(x[k]),
                                          np.asarray(y[k]), err_msg=k)
    for d1, d2 in ((wa, wb), (ga, gb)):
        assert d1.keys() == d2.keys()
        for k in d1:
            np.testing.assert_array_equal(d1[k], d2[k], err_msg=k)
    if sa is not None:
        np.testing.assert_array_equal(sa.amax_history, sb.amax_history)
        np.testing.assert_array_equal(sa.scale, sb.scale)


@pytest.fixture(scope="module")
def no_remat_runs():
    return {case: remat_run(case, False) for case in REMAT_CASES}


@pytest.mark.parametrize("case", list(REMAT_CASES))
def test_remat_equals_no_remat_bitwise(no_remat_runs, case, monkeypatch):
    calls = []
    orig = tremat.checkpointed

    def counting(fn, gen, *args):
        calls.append(1)
        return orig(fn, gen, *args)
    for mod in ("repro_torch.models.transformer",
                "repro_torch.models.attention"):
        monkeypatch.setattr(f"{mod}.checkpointed", counting)
    got = remat_run(case, True)
    assert calls, "no region was recomputed"
    assert_runs_equal(got, no_remat_runs[case])
    if case == "hybrid_delayed_sr":
        assert any(k.startswith("health/") for k in got[0][0])


@pytest.mark.parametrize("fault", ["step_generator", "scope"])
def test_remat_faults_break_the_equality(no_remat_runs, fault,
                                         monkeypatch):
    """The recomputation drawing its bits from the step's own generator
    (advancing it in the middle of the backward), or running at the empty
    scope the backward leaves (other sites' scales, other keys)."""
    if fault == "step_generator":
        monkeypatch.setattr(tremat, "replay_generator",
                            lambda gen, state: gen)
    else:
        monkeypatch.setattr(tsc, "at_scope",
                            lambda path: contextlib.nullcontext())
    got = remat_run("hybrid_delayed_sr", True)
    with pytest.raises(AssertionError):
        assert_runs_equal(got, no_remat_runs["hybrid_delayed_sr"])


def test_remat_follows_the_scanned_stack():
    """Recomputation where the reference's scanned stack recomputes:
    remat and scan_layers on and more than one layer; a one-layer stack
    or scan_layers=False trains without it."""
    from repro_torch.models.transformer import _remat
    cfg = remat_cfg("paper_sr", True)
    assert _remat(cfg, 2) and not _remat(cfg, 1)
    assert not _remat(cfg.replace(scan_layers=False), 2)
    assert not _remat(cfg.replace(remat=False), 2)
    assert tmc.ModelConfig().remat and tmc.ModelConfig().scan_layers
