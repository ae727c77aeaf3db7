"""The paper's convnet workload in the port against `repro` on the CPU.

  * patch extraction: `F.unfold` after the reference's SAME padding
    (asymmetric at stride 2) equals `lax.conv_general_dilated_patches` bit
    for bit, at stride 1 and 2, k = 1 and 3, even and odd sizes;
  * `qconv2d` under `PAPER_FP8_RNE` on the kernel backend ("pallas" here,
    "pallas_interpret" in the reference): forward and both adjoints bit for
    bit on exact fixtures (e5m2 values with exponents {0, 1}: every f32
    sum exact); the model-level tests run the reference on its "xla"
    backend (`kernel_cfgs`);
  * `_groupnorm`, and `resnet_forward` / `resnet_loss` (loss and the
    gradient of every leaf) at the reference's weights, all-RNE: the f32
    reductions (GroupNorm statistics, pooling, log-softmax) round in
    another order than XLA's, and the e5m2 Q nodes turn a last-bit
    difference into a grid notch, so they are held to limits set from
    readings, which a planted fault in the fp8 GEMM must exceed;
  * `synthetic_image_batches`, the scalers' state machines,
    `underflow_fraction` and `l2_regularization_loss` / the learning-rate
    schedule;
  * tier D: the `train_convnet` counterpart at the reference's
    `(1, 1), (16, 32)` 16x16 configuration, RNE within a band of the
    reference's trajectory, and SR within 3x the band of three reference
    runs with different step keys.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.fp8_matmul.ops  # noqa: F401  (jitted before patching)
from repro.core import loss_scale as jls
from repro.core import qconv as jqc
from repro.core.master_weights import MixedPrecisionOptimizer
from repro.core.precision_policy import PAPER_FP8, PAPER_FP8_RNE
from repro.data.pipeline import synthetic_image_batches as j_images
from repro.models import resnet as jres
from repro.optim import optimizers as jopt
from repro_torch.core import loss_scale as tls
from repro_torch.core import precision_policy as tpp
from repro_torch.core import qconv as tqc
from repro_torch.data.pipeline import synthetic_image_batches
from repro_torch.kernels.fp8_matmul import ops as tmm
from repro_torch.models import resnet as tres
from repro_torch.models.registry import build_config
from repro_torch.optim import optimizers as topt
from repro_torch.train import convnet as tconv

jax.config.update("jax_platform_name", "cpu")

PER_OP = {"xla_allow_excess_precision": False}
# Limits set from readings on the CPU (all-RNE, the reference's weights,
# one 16-image batch). The logits and the loss read bitwise equal, the
# gradients of all leaves together rel L2 2.7e-8 (worst leaf 4.1e-7, a GN
# scale): the convs are bitwise, and only the f32 reductions (GroupNorm
# statistics, pooling, the L2 sum) round in another order. The limits
# leave room for torch's reductions to split by thread count, which an
# e5m2 Q node can turn into a grid notch; the planted fault (the fp8 GEMM
# without its last K rows) reads 0.39.
GN_ATOL = 1e-5
LOGITS_REL_L2 = 1e-2
LOSS_REL = 1e-3
GRAD_REL_L2 = 1e-2
# Tier D, 6 steps at batch 32 (readings: the RNE trajectories at most
# 3.2e-3 apart; three SR reference runs 1.1e-2 apart, the port 9.0e-3 from
# their mean).
RNE_BAND = 3e-2
BAND_FACTOR = 3.0
SMALL = dict(depth_per_stage=(1, 1), widths=(16, 32))
STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for this file: the suite runs
    in several worker processes on a few cores, and eight OpenMP threads a
    worker oversubscribe them (this file's CPU training runs were seen to
    run ten times slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The reference's initializer, jitted once (op by op it compiles each
# random draw apart).
ref_init = jax.jit(jres.init_resnet, static_argnums=1)


def per_op(fn):
    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "jit", functools.partial(jax.jit,
                                                     compiler_options=PER_OP))
            return fn(*a, **kw)
    return wrapped


def exact_e5m2(shape, rng):
    """e5m2 values (as f32) with exponents {0, 1}."""
    sign = rng.choice([-1.0, 1.0], shape)
    m = rng.integers(0, 4, shape) / 4
    return (sign * (1 + m) * np.exp2(rng.integers(0, 2, shape))).astype(
        np.float32)


def f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def rel_l2(got, want) -> float:
    g, w = f32(got).astype(np.float64), f32(want).astype(np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(flat(tree[k], f"{path}/{k}"))
        return out
    return {path: f32(tree)}


def tree_rel_l2(want, got):
    w, g = flat(want), flat(got)
    assert w.keys() == g.keys()
    num = sum(float(np.sum((w[k].astype(np.float64) - g[k]) ** 2)) for k in w)
    den = sum(float(np.sum(w[k].astype(np.float64) ** 2)) for k in w)
    return float(np.sqrt(num / den))


def kernel_cfgs(rne=True, reference_backend="xla"):
    """(reference, port) QuantConfigs of the paper's recipe: the port on
    its kernel backend; the reference on `reference_backend` — "xla"
    compiles far faster than "pallas_interpret" and computes the same
    numbers on the unfused path (tests/test_torch_unfused.py holds the two
    equal on a training step), "pallas_interpret" for the per-op test."""
    jq = PAPER_FP8_RNE if rne else PAPER_FP8
    tq = tpp.PAPER_FP8_RNE if rne else tpp.PAPER_FP8
    return (dataclasses.replace(jq, backend=reference_backend),
            dataclasses.replace(tq, backend="pallas"))


# ---------------------------------------------------------------------------
# qconv
# ---------------------------------------------------------------------------

CONV_CASES = [(k, s, h) for k in (1, 3) for s in (1, 2) for h in (8, 7)]


@pytest.mark.parametrize("k,stride,size", CONV_CASES)
def test_patches_bitwise(k, stride, size):
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    want = jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), (k, k), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tqc.patches(torch.from_numpy(x), k, k, (stride, stride))
    np.testing.assert_array_equal(f32(got), np.asarray(want))


@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_qconv2d_forward_and_adjoints_bitwise(k, stride):
    rng = np.random.default_rng(10 * k + stride)
    x, w = exact_e5m2((2, 8, 8, 4), rng), exact_e5m2((k, k, 4, 8), rng)
    jq, tq = kernel_cfgs(reference_backend="pallas_interpret")

    def f(x_, w_):
        return jqc.qconv2d(x_, w_, stride=(stride, stride), cfg=jq)

    y_j, vjp = jax.vjp(f, jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(w, jnp.bfloat16))
    dy = exact_e5m2(y_j.shape, rng)
    dx_j, dw_j = vjp(jnp.asarray(dy, jnp.bfloat16))
    xt = torch.tensor(x).bfloat16().requires_grad_(True)
    wt = torch.tensor(w).bfloat16().requires_grad_(True)
    y_t = tqc.qconv2d(xt, wt, stride=(stride, stride), cfg=tq)
    y_t.backward(torch.tensor(dy).bfloat16())
    for got, want in ((y_t, y_j), (xt.grad, dx_j), (wt.grad, dw_j)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(f32(got), f32(want))
    assert np.count_nonzero(f32(dw_j)) > 0


def test_qconv2d_forward_runs_fp8_matmul(monkeypatch):
    """Under the kernel backend the conv's forward GEMM is the fp8 GEMM op
    (its plain version on the CPU), at (B*H'*W', 9*C_in) x (9*C_in,
    C_out)."""
    calls = []
    orig = tmm.fp8_matmul

    def spy(a, b, out_dtype=torch.float32):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return orig(a, b, out_dtype)
    monkeypatch.setattr(tmm, "fp8_matmul", spy)
    x = torch.randn((2, 8, 8, 4)).bfloat16().requires_grad_(True)
    w = torch.randn((3, 3, 4, 8)).requires_grad_(True)
    y = tqc.qconv2d(x, w, stride=(2, 2), cfg=kernel_cfgs(rne=False)[1],
                    generator=torch.Generator().manual_seed(0))
    y.float().sum().backward()
    assert y.shape == (2, 4, 4, 8) and calls == [((32, 36), (36, 8))]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_groupnorm_within_limit():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 8, 8, 32)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    want = jres._groupnorm({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x, jnp.bfloat16))
    got = tres._groupnorm(to_torch(p), torch.tensor(x).bfloat16())
    assert got.dtype == torch.bfloat16
    ulp_ok = np.abs(f32(got) - f32(want)) <= GN_ATOL + 2.0 ** -7 * np.abs(
        f32(want))   # at most one bf16 rounding apart
    assert ulp_ok.all()
    wf = jres._groupnorm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    gf = tres._groupnorm(to_torch(p), torch.tensor(x))
    np.testing.assert_allclose(f32(gf), np.asarray(wf), rtol=0, atol=GN_ATOL)


@pytest.fixture(scope="module")
def rne_model():
    """The reference's weights, loss, logits and gradients (all-RNE, one
    batch of 16 images), and the port's config and weights."""
    jq, tq = kernel_cfgs()
    jcfg = jres.ResNetConfig(quant=jq, **SMALL)
    tcfg = tres.ResNetConfig(quant=tq, **SMALL)
    jp = ref_init(jax.random.PRNGKey(0), jcfg)
    batch = next(j_images(batch_size=16, image_size=16, noise=1.6))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @per_op
    def reference():
        def loss_grads_logits(p):
            (loss, met), grads = jax.value_and_grad(
                lambda q: jres.resnet_loss(q, jb, cfg=jcfg), has_aux=True)(p)
            return loss, met, grads, jres.resnet_forward(p, jb["image"],
                                                         cfg=jcfg)
        return jax.jit(loss_grads_logits)(jp)

    loss, met, grads, logits = reference()
    loss = float(loss)
    return dict(tcfg=tcfg, tp=to_torch(jax.tree_util.tree_map(np.asarray, jp)),
                batch=batch, loss=loss, met=met, logits=logits,
                grads=jax.tree_util.tree_map(np.asarray, grads))


def port_loss_grads(s):
    params = topt.tmap(lambda p: p.clone().requires_grad_(True), s["tp"])
    loss, met = tres.resnet_loss(params, s["batch"], cfg=s["tcfg"])
    loss.backward()
    return loss.item(), met, topt.tmap(lambda p: p.grad, params)


def test_resnet_forward_and_loss_within_limit(rne_model):
    s = rne_model
    logits = tres.resnet_forward(s["tp"], torch.from_numpy(
        s["batch"]["image"]), cfg=s["tcfg"])
    assert logits.dtype == torch.float32 and logits.shape == (16, 10)
    assert rel_l2(logits, s["logits"]) <= LOGITS_REL_L2
    loss, met, grads = port_loss_grads(s)
    assert abs(loss - s["loss"]) <= LOSS_REL * abs(s["loss"])
    assert abs(met["l2_loss"].item() - float(s["met"]["l2_loss"])) <= \
        1e-5 * float(s["met"]["l2_loss"])
    rel = tree_rel_l2(s["grads"], grads)
    assert rel <= GRAD_REL_L2, rel


def test_resnet_planted_fault_exceeds_limit(rne_model, monkeypatch):
    """The fp8 GEMM without its last 4 K rows (a kernel-5 fault) must read
    above the gradient limit."""
    orig = tmm.fp8_matmul

    def drop_last_k(a, b, out_dtype=torch.float32):
        k = a.shape[1] - 4
        return orig(a[:, :k].contiguous(), b[:k].contiguous(), out_dtype)
    monkeypatch.setattr(tmm, "fp8_matmul", drop_last_k)
    _, _, grads = port_loss_grads(rne_model)
    rel = tree_rel_l2(rne_model["grads"], grads)
    assert not rel <= GRAD_REL_L2, rel


def test_fp8_gemms_and_configs(monkeypatch):
    """ResNetConfig()'s forward runs 14 FP8 conv GEMMs through the fp8
    GEMM op (two a block, a 1x1 projection where a stage widens), as many
    as chip_smoke.py's phase 10 counts kernel-5 launches a step; the
    registry's config and the shapes of init_resnet are the reference's."""
    calls = []
    orig = tmm.fp8_matmul
    monkeypatch.setattr(tmm, "fp8_matmul", lambda a, b, out_dtype=torch.float32:
                        calls.append(a.shape) or orig(a, b, out_dtype))
    cfg = tres.ResNetConfig(quant=kernel_cfgs()[1])
    x = torch.randn((1, 8, 8, 3))
    with torch.no_grad():
        tres.resnet_forward(tres.init_resnet(cfg, device="cpu"), x, cfg=cfg)
    assert len(calls) == 14
    from repro_torch.configs.paper_resnet import resnet_config
    assert resnet_config() == tres.ResNetConfig()
    assert build_config("paper-resnet").arch == "paper-resnet"
    p = tres.init_resnet(tres.ResNetConfig(), device="cpu")
    jp = jax.eval_shape(lambda: jres.init_resnet(jax.random.PRNGKey(0),
                                                 jres.ResNetConfig()))
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), jp)
    assert topt.tmap(lambda x: tuple(x.shape), p) == shapes


# ---------------------------------------------------------------------------
# data, scalers, L2, schedule
# ---------------------------------------------------------------------------

def test_image_batches_bitwise():
    kw = dict(batch_size=5, image_size=12, seed=3, task_seed=1, noise=1.6,
              start_step=2)
    for got, want in zip(synthetic_image_batches(**kw), j_images(**kw)):
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        break


@pytest.mark.parametrize("name", ["convnet", "gnmt", "transformer"])
def test_paper_scalers_state_machine_bitwise(name):
    jsc = {"convnet": jls.convnet_scaler(10_000.0), "gnmt": jls.gnmt_scaler(),
           "transformer": jls.transformer_scaler()}[name]
    tsc = {"convnet": tls.convnet_scaler(10_000.0),
           "gnmt": tls.gnmt_scaler(),
           "transformer": tls.transformer_scaler()}[name]
    assert dataclasses.asdict(tsc) == dataclasses.asdict(jsc)
    # Fewer growth steps and earlier knots, to reach every branch.
    jsc = dataclasses.replace(jsc, growth_interval=3,
                              min_scale_schedule=((5, 2.0 ** 14),))
    tsc = dataclasses.replace(tsc, growth_interval=3,
                              min_scale_schedule=((5, 2.0 ** 14),))
    js, ts = jsc.init(), tsc.init()
    for fin in [True] * 4 + [False] * 3 + [True, False, True]:
        js = jsc.update(js, jnp.asarray(fin))
        ts = tsc.update(ts, torch.tensor(fin))
        for f in ("scale", "growth_count", "step", "overflow_count"):
            assert np.asarray(getattr(js, f)) == getattr(ts, f).numpy(), f


def test_underflow_fraction_bitwise():
    rng = np.random.default_rng(5)
    thr = 1.52587890625e-05
    tree = {"a": (rng.standard_normal((64, 33)) * np.exp2(
        rng.integers(-22, 2, (64, 33)))).astype(np.float32),
        "b": {"c": np.array([0.0, thr / 2, thr / 2 * 0.999, -thr / 4, 1.0],
                            np.float32)},
        "n": np.arange(4, dtype=np.int32)}
    tree["a"][:3] = 0.0
    want = jls.underflow_fraction(jax.tree_util.tree_map(jnp.asarray, tree),
                                  threshold=thr)
    got = tls.underflow_fraction(topt.tmap(torch.from_numpy, tree),
                                 threshold=thr)
    assert got.dtype == torch.float32 and 0 < float(got) < 1
    assert np.float32(want) == got.numpy()
    bf = {"g": torch.from_numpy(tree["a"]).bfloat16()}
    want_bf = jls.underflow_fraction({"g": jnp.asarray(tree["a"],
                                                       jnp.bfloat16)},
                                     threshold=thr)
    assert np.float32(want_bf) == tls.underflow_fraction(
        bf, threshold=thr).numpy()


def test_l2_loss_and_warmup_schedule():
    rng = np.random.default_rng(6)
    tree = {"z": rng.standard_normal((7, 5)).astype(np.float32),
            "a": {"w": rng.standard_normal(300).astype(np.float32)}}
    want = jopt.l2_regularization_loss(
        jax.tree_util.tree_map(jnp.asarray, tree), 5e-4)
    got = topt.l2_regularization_loss(topt.tmap(torch.from_numpy, tree), 5e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    js, ts = (jopt.warmup_rsqrt_schedule(3e-3, 40),
              topt.warmup_rsqrt_schedule(3e-3, 40))
    for c in (0, 1, 7, 39, 40, 41, 1000):
        np.testing.assert_allclose(
            ts(torch.tensor(c, dtype=torch.int32)).numpy(),
            np.asarray(js(jnp.asarray(c, jnp.int32))), rtol=1e-6)


# ---------------------------------------------------------------------------
# tier D: the convnet run
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference_step(quant):
    """The reference's train_convnet pieces (its benchmarks/common.py) at
    its configuration: the optimizer and one jitted step, compiled once
    per recipe."""
    cfg = jres.ResNetConfig(quant=quant, **SMALL)
    mcfg = jopt.MomentumConfig(learning_rate=0.05, momentum=0.9)
    init, update = jopt.momentum_sgd(mcfg)
    names, leaf = jopt.momentum_leafwise(mcfg)
    opt = MixedPrecisionOptimizer(inner_init=init, inner_update=update,
                                  scaler=jls.convnet_scaler(10_000.0),
                                  master_dtype="float16", accum_names=names,
                                  leaf_update=leaf)

    def step_fn(state, batch, key):
        (_, m), g = jax.value_and_grad(
            lambda p: jres.resnet_loss(p, batch, cfg=cfg, qkey=key,
                                       loss_scale=state.loss_scale.scale),
            has_aux=True)(opt.compute_params(state))
        state, _ = opt.apply_gradients(state, g)
        return state, m["nll"]

    return cfg, opt, jax.jit(step_fn, compiler_options=PER_OP)


def reference_run(quant, step_seed, batches):
    """The reference's convnet loop over `batches` from its initial
    weights: the train nll of each step."""
    cfg, opt, step_fn = reference_step(quant)
    state = opt.init(ref_init(jax.random.PRNGKey(0), cfg))
    nll = []
    for i, b in enumerate(batches):
        state, n = step_fn(state, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.fold_in(jax.random.PRNGKey(step_seed),
                                              i))
        nll.append(float(n))
    return np.asarray(nll)


def port_run(quant, steps):
    """The port's train_convnet from the reference's initial weights."""
    jp = ref_init(jax.random.PRNGKey(0), jres.ResNetConfig(**SMALL))
    hist = tconv.train_convnet(
        quant=quant, scaler=tls.convnet_scaler(), steps=steps, batch_size=32,
        eval_every=1, params=to_torch(jax.tree_util.tree_map(np.asarray, jp)),
        device="cpu")
    return np.asarray(hist["train_nll"])


@pytest.fixture(scope="module")
def image_stream():
    """train_convnet's first STEPS batches at batch size 32."""
    it = j_images(batch_size=32, image_size=16, seed=0, noise=1.6)
    return [next(it) for _ in range(STEPS)]


def test_convnet_rne_trajectory_within_band(image_stream):
    jq, tq = kernel_cfgs()
    want = reference_run(jq, 7, image_stream)
    got = port_run(tq, STEPS)
    assert np.all(np.isfinite(got))
    assert np.max(np.abs(got - want)) <= RNE_BAND, (got, want)
    assert got[-1] < got[0] and want[-1] < want[0]


def test_convnet_sr_trajectory_within_reference_band(image_stream):
    jq, tq = kernel_cfgs(rne=False)
    runs = [reference_run(jq, seed, image_stream) for seed in (7, 8, 9)]
    gap = max(float(np.max(np.abs(runs[i] - runs[j])))
              for i in range(3) for j in range(i + 1, 3))
    got = port_run(tq, STEPS)
    assert np.all(np.isfinite(got)) and gap > 0
    assert np.max(np.abs(got - np.mean(runs, axis=0))) <= BAND_FACTOR * gap
    assert got[-1] < got[0] and all(r[-1] < r[0] for r in runs)


def test_resnet_example_runs_on_cpu():
    """`python -m repro_torch.examples.resnet_fp8 --device cpu`, shortened:
    every run finite, the loss-scale sweep's underflow lower at 10000."""
    from repro_torch.examples import resnet_fp8
    out = resnet_fp8.main(["--device", "cpu", "--steps", "1"])
    assert set(out) == {"scale=1", "scale=10000", "fp32", "fp8+RNE",
                        "fp8+SR"}
    assert all(np.all(np.isfinite(h["train_nll"])) for h in out.values())
    assert np.mean(out["scale=10000"]["underflow_frac"]) <= np.mean(
        out["scale=1"]["underflow_frac"])
