"""The port's data parallelism and fp8 wire (`repro_torch.distributed`,
`make_train_step(plan=, amax_sync=)`, `TrainLoop(plan=)`) against
`repro.distributed`.

One module fixture runs everything that needs several processes at once:
 * four port ranks (tests/torch_dp_worker.py, gloo on FileStores under a
   temporary directory, one intra-op thread each, no jax) on a flat (4,)
   'data' mesh and a (2, 2) 'pod' x 'data' mesh, and two of them again on
   a (2,) mesh for the TrainLoop;
 * one reference subprocess on 4 forced host devices (as the reference's
   own multi-device tests run): its plans on (1,), (4,) and (2, 2) meshes,
   and 3 steps of its wire step on (2, 2) and of its "full" step on (4,).
The reference's compressed reduction also runs in this process, through
its own vmap harness (tests/test_distributed.py), at N = 2 and 4.

The steps run the reference tests' tiny qwen2 (2 layers, d_model 64,
vocab 512) under hybrid delayed scaling with every rounding RNE on the
xla backend, from the reference's weights, on global batches of 8 rows
whose loss masks differ between the shards (32, 24, 12 and 4 tokens a
row): the "full" path divides by the global count, the wire path by each
shard's own, and a planted local-mean fault in the "full" path must leave
the limits. Limits are the step tests' (tests/test_torch_train_step.py):
loss rel 1e-2, the update of the master weights (gradients through Adam)
rel L2 0.35.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.precision_policy import DistConfig as JDistConfig
from repro.core.precision_policy import QuantConfig as JQuantConfig
from repro.data.pipeline import host_shard as j_host_shard
from repro.distributed.grad_compress import compressed_psum_mean
from repro.distributed.grad_compress import wire_bytes_model as j_wire_bytes
from repro.models.registry import build_config as j_build_config
from repro.models.transformer import init_lm
from repro_torch.core.precision_policy import DistConfig
from repro_torch.data.pipeline import DataConfig, host_shard
from repro_torch.data.pipeline import synthetic_lm_batches
from repro_torch.distributed import host_amax_sync
from repro_torch.distributed.grad_compress import wire_bytes_model
from repro_torch.models.convert import (stack_wire_error, unstack_wire_error,
                                        wire_error_from_jax)
from repro_torch.models.registry import build_config

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]
LOSS_REL = 1e-2
UPDATE_REL_L2 = 0.35
CFG_KW = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab_size=512, remat=False)
QUANT_KW = dict(recipe="hybrid", scaling="delayed", backend="xla",
                act_rounding="rne", error_rounding="rne",
                grad_rounding="rne")
# Tokens of loss mask a row, by shard of the global batch (2 rows each).
MASK_TOKENS = (32, 24, 12, 4)
E5M2_MAX = 57344.0
# Error-feedback law cases: (seed, log10 of the gradients' scale).
EF_CASES = ((0, -6), (1, 0), (2, 3), (3, 6))
RANK_TIMEOUT = 600


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for this file (the suite runs
    in several worker processes on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_cfg():
    cfg = j_build_config("qwen2-1.5b", smoke=True).replace(
        scan_layers=False, **CFG_KW)
    pol = dataclasses.replace(cfg.policy, quant=JQuantConfig(**QUANT_KW))
    return cfg.replace(policy=pol)


def global_batches():
    """3 global batches (8 x 32) with uneven loss masks by shard."""
    src = synthetic_lm_batches(DataConfig(vocab_size=512, seq_len=32,
                                          batch_size=8, seed=0))
    out = []
    for _ in range(3):
        b = next(src)
        mask = np.zeros((8, 32), np.float32)
        for shard, n in enumerate(MASK_TOKENS):
            mask[2 * shard:2 * shard + 2, :n] = 1.0
        b["loss_mask"] = mask
        out.append(b)
    return out


def compress_fixtures(n, rng):
    """Per-rank leaves (n, ...). 'pow2': every rank's element 0 at 57344 x
    2^-10, so both shared scales are powers of two (2^-10 and n 2^-10),
    the others of random sign and log-uniform magnitude in [2^-8, 2^15)
    x 2^-10; 333 elements, so the flat payload pads. 'narrow': the same
    element 0, the others e5m2 grid values in [2^10, 2^15) x 2^-10, whose
    f32 sums over ranks are exact in any order (tier B). Both keep every
    quantize input but the maximum below 2^15, where the reference's CPU
    RNE rounds ties away from even (ROADMAP.md, queue 3). 'zero' (the
    1e-30 guard); 'tiny' (fewer elements than ranks); 'general' (scales
    not powers of two)."""
    m = np.float32(E5M2_MAX * 2.0 ** -10)
    sign = rng.choice([-1.0, 1.0], (n, 333))
    pow2 = (sign * 2.0 ** rng.uniform(-8, 15, (n, 333)) * 2.0 ** -10
            ).astype(np.float32)
    pow2[:, 0] = m
    mant = rng.choice([1.0, 1.25, 1.5, 1.75], (n, 256))
    expo = rng.integers(10, 15, (n, 256))
    sign = rng.choice([-1.0, 1.0], (n, 256))
    narrow = (sign * mant * 2.0 ** expo * 2.0 ** -10).astype(np.float32)
    narrow[:, 0] = m
    return {"pow2": pow2, "narrow": narrow,
            "zero": np.zeros((n, 17), np.float32),
            "tiny": rng.standard_normal((n, 1)).astype(np.float32),
            "general": (rng.standard_normal((n, 7, 5)) * 0.01
                        ).astype(np.float32)}


def payloads(v):
    """Values that are e5m2 payloads times one shared scale (up to a few
    f32 ulps of the scale's product) -> the payloads' codes. The largest
    magnitude is the payload 57344 (the shared scale is the amax over
    57344)."""
    m = np.abs(v).max()
    x = np.zeros(v.shape) if m == 0 else v.astype(np.float64) / m * E5M2_MAX
    return x.astype(ml_dtypes.float8_e5m2).view(np.uint8)


def neighbours_only(a, b):
    """Whether every differing e5m2 code pair is one grid step apart."""
    diff = a != b
    sa, sb = a >> 7, b >> 7
    mag = np.abs((a & 0x7F).astype(int) - (b & 0x7F).astype(int))
    return bool(((sa == sb) & (mag <= 1))[diff].all())


def reference_reduce(fix):
    """The reference's compressed_psum_mean through its vmap harness: slot
    i plays rank i. Returns (first step's reduced, residual, second step's
    reduced, residual), each (n, ...)."""
    g = {k: jnp.asarray(v) for k, v in fix.items()}
    first = jax.jit(jax.vmap(lambda t: compressed_psum_mean(
        t, None, axis_name="x"), axis_name="x"))
    step = jax.jit(jax.vmap(lambda t, e: compressed_psum_mean(
        t, e, axis_name="x"), axis_name="x"))
    red, err = first(g)
    red2, err2 = step(g, err)
    return tuple(jax.tree_util.tree_map(np.asarray, x)
                 for x in (red, err, red2, err2))


REF_SCRIPT = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.core.precision_policy import DistConfig
from repro.distributed.strategy import ParallelPlan
from repro.launch.mesh import enter_mesh, make_mesh
from repro.scaling import DelayedScaling, discover_lm_sites
from repro.train.step import make_optimizer_for, make_train_step

with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
cfg = inp["jcfg"]
params = jax.tree_util.tree_map(jnp.asarray, inp["params"])
meshes = {"1": Mesh(np.array(jax.devices()[:1]), ("data",)),
          "4": make_mesh((4,), ("data",)),
          "2x2": make_mesh((2, 2), ("pod", "data"))}
plans = {}
for name, mesh in meshes.items():
    plans[name] = {}
    for dname, kw in inp["dists"].items():
        try:
            plan = ParallelPlan.build(mesh, DistConfig(**kw))
        except (ValueError, NotImplementedError) as e:
            plans[name][dname] = ("error", type(e).__name__, str(e))
            continue
        plans[name][dname] = dict(
            describe=plan.describe(), wire_axis=plan.wire_axis,
            inner_dp_axes=plan.inner_dp_axes, n_wire=plan.n_wire,
            compresses=plan.compresses, wire_bytes=plan.wire_bytes(params))
reg = discover_lm_sites(cfg, params, {k: jnp.asarray(v)
                                      for k, v in inp["probe"].items()})
ds = DelayedScaling(reg, qcfg=cfg.policy.quant)
opt = make_optimizer_for(cfg, learning_rate=1e-3)
runs = {}
for run, mesh_name, wire in (("wire", "2x2", "fp8_ef"), ("full", "4", "full")):
    mesh = meshes[mesh_name]
    plan = ParallelPlan.build(mesh, DistConfig(wire=wire, zero1=False,
                                               tp=False))
    step = jax.jit(make_train_step(cfg, opt, scaling=ds, plan=plan))
    state, ss = opt.init(params), ds.init()
    err = plan.init_wire_state(state.master) if plan.compresses else None
    mets, err0 = [], None
    with enter_mesh(mesh):
        for i, b in enumerate(inp["batches"]):
            k = jax.random.fold_in(jax.random.PRNGKey(7), i)
            b = {kk: jnp.asarray(v) for kk, v in b.items()}
            if err is None:
                (state, ss), m = step(state, ss, b, k)
            else:
                (state, ss, err), m = step(state, ss, err, b, k)
                if i == 0:
                    err0 = jax.tree_util.tree_map(np.asarray, err)
            mets.append({kk: float(m[kk]) for kk in
                         ("loss", "grad_norm", "loss_scale")})
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
    runs[run] = dict(metrics=mets, master=np_(state.master),
                     err=np_(err) if err is not None else None, err0=err0,
                     amax_history=np.asarray(ss.amax_history),
                     scale=np.asarray(ss.scale), keys=list(reg.keys))
with open(sys.argv[2], "wb") as f:
    pickle.dump({"plans": plans, "runs": runs}, f)
"""


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Runs the ranks, the reference subprocess and the in-process vmap
    reference; returns their results."""
    import repro_torch
    work = tmp_path_factory.mktemp("dp")
    jcfg = jax_cfg()
    params = jax.tree_util.tree_map(np.asarray,
                                    init_lm(jax.random.PRNGKey(0), jcfg))
    batches = global_batches()
    rng = np.random.default_rng(11)
    compress = {n: compress_fixtures(n, rng) for n in (4, 2)}
    ef = [(np.random.default_rng(seed).standard_normal((4, 97))
           * 10.0 ** lg).astype(np.float32) for seed, lg in EF_CASES]
    probe = {k: v[:1] for k, v in batches[0].items()}
    from torch_dp_worker import DISTS
    inp = dict(params=params, batches=batches, compress=compress, ef=ef,
               probe=probe, cfg_kw=CFG_KW, quant_kw=QUANT_KW)
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    with open(work / "ref_in.pkl", "wb") as f:
        pickle.dump(dict(jcfg=jcfg, params=params, batches=batches,
                         probe=probe, dists=DISTS), f)
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_allow_excess_precision=false")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_SCRIPT),
         str(work / "ref_in.pkl"), str(work / "ref_out.pkl")],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    wenv = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen(
        [sys.executable, str(Path(__file__).with_name("torch_dp_worker.py")),
         str(r), str(work)], env=wenv, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    vmap_ref = {n: reference_reduce(compress[n]) for n in (4, 2)}
    step_all = jax.jit(jax.vmap(lambda t, e: compressed_psum_mean(
        t, e, axis_name="x"), axis_name="x"))
    ef_ref = [np.asarray(step_all({"g": jnp.asarray(g)},
                                  {"g": jnp.zeros_like(g)})[0]["g"])
              for g in ef]
    logs = []
    try:
        for p in ranks:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
        ref_out, ref_err = ref.communicate(timeout=RANK_TIMEOUT)
    finally:
        for p in ranks + [ref]:
            if p.poll() is None:
                p.kill()
    assert ref.returncode == 0, ref_err[-3000:]
    out = []
    for r in range(4):
        path = work / f"rank{r}.pkl"
        assert path.exists(), logs[r][-3000:]
        with open(path, "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, f"rank {r}:\n{res.get('error')}"
        out.append(res)
    with open(work / "ref_out.pkl", "rb") as f:
        ref_res = pickle.load(f)
    return dict(ranks=out, ref=ref_res, vmap=vmap_ref, ef_ref=ef_ref,
                inp=inp, jcfg=jcfg)


def rel(a, b):
    return abs(a - b) / abs(b)


def rel_l2(a, b):
    a = np.concatenate([np.ravel(x) for x in a])
    b = np.concatenate([np.ravel(x) for x in b])
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def leaves_t(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(leaves_t(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def leaves(tree):
    return {k: np.asarray(v) for k, v in leaves_t(tree).items()}


def tcfg():
    cfg = build_config("qwen2-1.5b", smoke=True, **CFG_KW)
    from repro_torch.core.precision_policy import QuantConfig
    return cfg.replace(policy=dataclasses.replace(
        cfg.policy, quant=QuantConfig(**QUANT_KW)))


# ---------------------------------------------------------------------------
# pure pieces, in this process
# ---------------------------------------------------------------------------

def test_dist_config_is_the_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(DistConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(JDistConfig)]
    for kw, match in (({"wire": "fp4"}, "wire format"),
                      ({"wire_zero_gather": "e5m2"}, "zero-gather")):
        with pytest.raises(ValueError, match=match):
            DistConfig(**kw)
        with pytest.raises(ValueError, match=match):
            JDistConfig(**kw)
    d = dataclasses.replace(DistConfig(), wire="fp8_ef")
    assert d.wire == "fp8_ef"
    assert dataclasses.replace(d, wire="full").wire == "full"
    assert tcfg().policy.dist == DistConfig()


@pytest.mark.parametrize("n_hosts", [1, 2, 4, 8])
def test_host_shard_is_the_reference(n_hosts):
    b = global_batches()[0]
    for h in range(n_hosts):
        got, want = host_shard(b, h, n_hosts), j_host_shard(b, h, n_hosts)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_wire_bytes_model_is_the_reference(n):
    tree = {"a": np.zeros((10, 10)), "b": {"c": np.zeros((3,))}}
    assert wire_bytes_model(tree, n) == j_wire_bytes(tree, n)
    ttree = {"a": torch.zeros(10, 10), "b": {"c": torch.zeros(3)}}
    assert wire_bytes_model(ttree, n) == j_wire_bytes(tree, n)
    if n > 1:
        assert wire_bytes_model(tree, n)["ratio_fp8_vs_bf16"] <= 0.55


def test_host_amax_sync_is_the_identity_on_one_process(dp):
    vec = np.array([1.0, 3.0], np.float32)
    assert host_amax_sync(vec) is vec
    assert all(r["host_amax_sync_solo"] for r in dp["ranks"])


def test_residual_layouts_round_trip(dp):
    """The reference's stacked residual -> the port's per-rank residuals
    -> stacked again, leaf for leaf."""
    err = dp["ref"]["runs"]["wire"]["err"]
    per_rank = wire_error_from_jax(err, tcfg(), device="cpu")
    assert len(per_rank) == 2
    back = stack_wire_error(per_rank)
    for i in range(2):
        one = unstack_wire_error(back, i)
        for k, v in leaves(one).items():
            np.testing.assert_array_equal(v, leaves(per_rank[i])[k])
    want = leaves(jax.tree_util.tree_map(np.asarray, err))
    got = {k: v.numpy() for k, v in leaves_t(back).items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def test_ranks_import_no_jax(dp):
    assert not any(r["jax_loaded"] for r in dp["ranks"])


@pytest.mark.parametrize("mesh", ["1", "4", "2x2"])
def test_plans_are_the_reference(dp, mesh):
    """describe(), the axis bookkeeping and wire_bytes of each DistConfig
    on the mesh, or the same error type, as the reference's plan."""
    want = dp["ref"]["plans"][mesh]
    for r in dp["ranks"]:
        got = r["plans"][mesh]
        assert got.keys() == want.keys()
        for name in want:
            if isinstance(want[name], tuple):
                assert got[name][0] == "error"
                assert got[name][1] == want[name][1], (name, got[name])
                continue
            assert got[name] == want[name], (mesh, name)
    if mesh == "1":
        fp8 = dp["ranks"][0]["plans"]["1"]["fp8"]
        assert fp8["describe"]["wire"] == "fp8_ef" and not fp8["compresses"]
        assert fp8["wire_bytes"]["bytes_per_step"] == 0.0


def _port_reduce(dp, n):
    """The port's (red, err, red2, err2) at N, stacked in slot order, and
    every rank's red equal to its group's."""
    ranks = dp["ranks"]
    slots = range(4) if n == 4 else (0, 2)   # ranks 0, 2: pod slots 0, 1
    out = []
    for key in ("red", "err", "red2", "err2"):
        out.append({k: np.stack([ranks[r]["compress"][n][key][k]
                                 for r in slots])
                    for k in ranks[0]["compress"][n][key]})
    return out


@pytest.mark.parametrize("n", [4, 2])
def test_payloads_bitwise_on_power_of_two_scales(dp, n):
    """With both shared scales powers of two, every division is exact: the
    rank's dequantized contribution (hence its payload and its residual)
    and the reduced mean (hence the all-gather payload) are the
    reference's bit for bit, on the first step and on the second (from
    the first's residual), the padded 333-element leaf and the all-zero
    one (the 1e-30 guard) among them; on the narrow-exponent leaf the f32
    sum over ranks is exact as well (tier B). The mean is the same on
    every rank."""
    red, err, red2, err2 = _port_reduce(dp, n)
    jred, jerr, jred2, jerr2 = dp["vmap"][n]
    for leaf in ("pow2", "narrow", "zero"):
        for got, want in ((err, jerr), (err2, jerr2), (red, jred),
                          (red2, jred2)):
            np.testing.assert_array_equal(got[leaf], want[leaf])
        for x in (red[leaf], red2[leaf]):
            assert (x == x[0]).all()
    assert float(np.abs(red["zero"]).max()) == 0.0
    assert float(np.abs(err["zero"]).max()) == 0.0


@pytest.mark.parametrize("n", [4, 2])
def test_general_inputs_within_the_flip_rate(dp, n):
    """Shared scales that are not powers of two: XLA may divide by a scale
    as a multiply by its reciprocal, so a payload may flip to its grid
    neighbour, and the dequantized values read a few f32 ulps apart. Both
    legs' payloads (recovered from the contributions and the means) flip
    in at most 1e-2 of the elements, to neighbours only; the values agree
    within 2^-20 relative where the payloads do. The one-element leaf
    (padded to N) among them."""
    fix = dp["inp"]["compress"][n]
    red, err, _, _ = _port_reduce(dp, n)
    jred, jerr, _, _ = dp["vmap"][n]
    for leaf in ("general", "tiny"):
        y = fix[leaf]
        legs = ((payloads(y - err[leaf]), payloads(y - jerr[leaf])),
                (payloads(red[leaf]), payloads(jred[leaf])))
        for i, (a, b) in enumerate(legs):
            rate = float(np.mean(a != b))
            print(f"N={n} {leaf}: leg {i + 1} payload flips {rate}")
            assert rate <= 1e-2 and neighbours_only(a, b)
        same = legs[1][0] == legs[1][1]
        np.testing.assert_allclose(red[leaf][same], jred[leaf][same],
                                   rtol=2.0 ** -20, atol=0)
        assert (red[leaf] == red[leaf][0]).all()


@pytest.mark.parametrize("n", [4, 2])
def test_counted_payload_bytes_are_the_model(dp, n):
    """The bytes comm counted for the fixture tree's reduction: the ring
    model's 2 (N-1)/N per element at one byte, plus the padding of each
    leaf to a multiple of N; against bf16 at most 0.55."""
    fix = dp["inp"]["compress"][n]
    shapes = {k: v.shape[1:] for k, v in fix.items()}
    numel = {k: int(np.prod(s)) for k, s in shapes.items()}
    pad = sum((-m) % n for m in numel.values())
    model = wire_bytes_model({k: np.zeros(s) for k, s in shapes.items()}, n)
    hops = 2.0 * (n - 1) / n
    want = model["bytes_fp8_ef"] + hops * pad
    for r in dp["ranks"]:
        assert r["compress"][n]["payload_bytes"] == pytest.approx(want,
                                                                  rel=0,
                                                                  abs=1e-6)
    assert want / model["bytes_full_bf16"] <= 0.55


@pytest.mark.parametrize("case", range(len(EF_CASES)))
def test_error_feedback_law(dp, case):
    """The reference's test_error_feedback_unbiased_over_steps on the
    port: constant per-rank gradients, 16 steps; the accumulated
    compressed mean tracks 16 x the true mean within one residual, better
    than a single step does. The first step's mean is the reference's
    within the flip-rate bound."""
    g = dp["inp"]["ef"][case]
    true = g.mean(0)
    red1, acc = dp["ranks"][0]["ef"][case]
    for r in dp["ranks"][1:]:
        np.testing.assert_array_equal(r["ef"][case][1], acc)
    rel1 = np.linalg.norm(red1 - true) / np.linalg.norm(true)
    rel_acc = np.linalg.norm(acc - 16 * true) / (16 * np.linalg.norm(true))
    assert rel_acc < max(rel1, 1e-6) + 1e-7, (rel_acc, rel1)
    assert rel_acc < 0.05, rel_acc
    a, b = payloads(red1), payloads(dp["ef_ref"][case][0])
    assert float(np.mean(a != b)) <= 1e-2 and neighbours_only(a, b)


@pytest.mark.parametrize("run", ["wire", "full"])
def test_train_steps_within_the_step_limits(dp, run):
    """3 steps of the port's plan step on every rank against the
    reference's (wire: fp8_ef on (2, 2); full: (4,)), from the same
    weights and batches. The site registry is the reference's; each
    step's loss within LOSS_REL; the master weights' update within
    UPDATE_REL_L2; the first step's observations (the oldest column of
    the amax history) within one e5m2 notch (factor 1.25) site by site,
    the weight-gradient (G) sites among them: under "full" each wgrad Q
    node quantizes and observes the sum over the ranks, as the
    reference's one program over the global batch does. Both packages
    overflow at step 1 (loss scale 8192 -> 4096) and skip it; on the wire
    that leaves the residual non-finite in both, the reference's
    semantics, so the later wire steps skip too (ROADMAP.md, queue 3). On
    the wire the residual after step 0 is the quantization error of
    gradients that differ in notches, so it is decorrelated from the
    reference's element by element (rel L2 ~1.35, printed); its norm is
    the reference's slot's within UPDATE_REL_L2, and after the overflow
    both hold non-finite values in the same places."""
    ref = dp["ref"]["runs"][run]
    params = tcfg_params(dp)
    finite = [m["grads_finite"] for m in dp["ranks"][0]["train"][run][
        "metrics"]]
    ref_finite = [bool(np.isfinite(m["grad_norm"])) for m in ref["metrics"]]
    assert finite == ref_finite, (finite, ref_finite)
    for r in dp["ranks"]:
        got = r["train"][run]
        assert got["keys"] == ref["keys"]
        for a, b in zip(got["metrics"], ref["metrics"]):
            assert rel(a["loss"], b["loss"]) <= LOSS_REL, (a, b)
            assert a["loss_scale"] == b["loss_scale"]
        upd = {k: v.astype(np.float32) - params[k]
               for k, v in leaves(got["master"]).items()}
        jmaster = from_jax(dp, ref["master"])
        jupd = {k: jmaster[k].astype(np.float32) - params[k] for k in upd}
        e = rel_l2([upd[k] for k in sorted(upd)],
                   [jupd[k] for k in sorted(upd)])
        print(f"{run} rank {got['dp_rank']}: update rel L2 {e:.4f}, losses "
              f"{[m['loss'] for m in got['metrics']]} vs "
              f"{[m['loss'] for m in ref['metrics']]}")
        assert e <= UPDATE_REL_L2
        a, b = got["amax_history"][:, 2], ref["amax_history"][:, 2]
        assert ((a > 0) == (b > 0)).all()
        grad = np.array([k.endswith("#G") for k in got["keys"]])
        notch = a > 0
        ratio = a[notch] / b[notch]
        assert ((ratio <= 1.25) & (ratio >= 0.8)).all()
        g = (a > 0) & grad
        assert g.any()
        print(f"{run}: G sites' first amax / the reference's in "
              f"[{(a[g] / b[g]).min():.3f}, {(a[g] / b[g]).max():.3f}]")
    if run == "wire":
        jerr = wire_error_from_jax(ref["err0"], tcfg(), device="cpu")
        for r in dp["ranks"]:
            got = leaves(r["train"]["wire"]["err0"])
            slot = r["train"]["wire"]["dp_rank"] // 2
            want = {k: v.numpy() for k, v in leaves_t(jerr[slot]).items()}
            e = rel_l2([got[k] for k in sorted(got)],
                       [want[k] for k in sorted(got)])
            norm = [np.linalg.norm(np.concatenate(
                [np.ravel(t[k]) for k in sorted(got)])) for t in (got, want)]
            size = abs(norm[0] - norm[1]) / norm[1]
            print(f"wire rank {r['train']['wire']['dp_rank']}: step-0 "
                  f"residual rel L2 {e:.4f} (decorrelated), its norm "
                  f"{norm[0]:.6g} vs {norm[1]:.6g}, rel {size:.4f}")
            assert size <= UPDATE_REL_L2
            assert max(float(np.abs(v).max()) for v in got.values()) > 0
            final = leaves(r["train"]["wire"]["err"])
            jfinal = from_jax(dp, unstack_np(ref["err"], slot))
            for k in final:
                np.testing.assert_array_equal(np.isfinite(final[k]),
                                              np.isfinite(jfinal[k]))


def unstack_np(tree, i):
    return jax.tree_util.tree_map(lambda x: np.asarray(x)[i], tree)


def tcfg_params(dp):
    return from_jax(dp, dp["inp"]["params"])


def from_jax(dp, tree):
    from repro_torch.models.convert import from_jax_params
    t = from_jax_params(jax.tree_util.tree_map(np.asarray, tree), tcfg(),
                        device="cpu")
    return {k: v.float().numpy() for k, v in leaves_t(t).items()}


@pytest.mark.parametrize("run", ["wire", "full"])
def test_replicas_stay_bit_identical(dp, run):
    """Master weights, optimizer moments, loss scale and ScaleState equal
    on every rank, bit for bit, after 3 steps; on the wire the residuals
    equal within each pod slot (its ranks reduce over 'data' first)."""
    runs = [r["train"][run] for r in dp["ranks"]]
    first = runs[0]
    for other in runs[1:]:
        for part in ("master", "opt", "loss_scale"):
            a, b = leaves(first[part]), leaves(other[part])
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(first["amax_history"],
                                      other["amax_history"])
        np.testing.assert_array_equal(first["scale"], other["scale"])
        for a, b in zip(first["metrics"], other["metrics"]):
            assert a.keys() == b.keys()
            np.testing.assert_array_equal([a[k] for k in sorted(a)],
                                          [b[k] for k in sorted(b)])
    if run == "wire":
        by_slot = {}
        for r in runs:
            by_slot.setdefault(r["dp_rank"] // 2, []).append(leaves(r["err"]))
        assert len(by_slot) == 2
        for errs in by_slot.values():
            for k in errs[0]:
                np.testing.assert_array_equal(errs[0][k], errs[1][k])


def test_the_normalizations_are_told_apart(dp):
    """With uneven masks by shard, the "full" step must divide by the
    global count: the planted local-mean fault leaves the limits the
    fault-free step keeps (test above)."""
    ref = dp["ref"]["runs"]["full"]
    bad = dp["ranks"][0]["train"]["full_localmean"]
    params = tcfg_params(dp)
    upd = {k: v.astype(np.float32) - params[k]
           for k, v in leaves(bad["master"]).items()}
    jmaster = from_jax(dp, ref["master"])
    e = rel_l2([upd[k] for k in sorted(upd)],
               [jmaster[k].astype(np.float32) - params[k]
                for k in sorted(upd)])
    loss = max(rel(a["loss"], b["loss"])
               for a, b in zip(bad["metrics"], ref["metrics"]))
    print(f"local-mean fault: update rel L2 {e:.4f}, loss rel {loss:.3e}")
    assert e > UPDATE_REL_L2 or loss > LOSS_REL


def test_amax_sync_equalizes_scale_states(dp):
    """Without a plan, four ranks on different shards: with the amax_sync
    hook their ScaleStates after a step are equal (the MAX of the ranks'
    observations), without it they differ."""
    synced = [r["amax_sync"]["synced"] for r in dp["ranks"]]
    plain = [r["amax_sync"]["plain"] for r in dp["ranks"]]
    for s in synced[1:]:
        np.testing.assert_array_equal(s[0], synced[0][0])
        np.testing.assert_array_equal(s[1], synced[0][1])
    assert any(not np.array_equal(p[0], plain[0][0]) for p in plain[1:])
    # The synced vector is the element-wise MAX of the plain ones.
    np.testing.assert_array_equal(
        synced[0][0][:, 0], np.max([p[0][:, 0] for p in plain], axis=0))


def test_slice_10b_and_moe_full_are_refused(dp):
    """Tensor parallelism on a (2, 2) mesh builds and steps for the dense
    decoder (tests/test_torch_tp.py holds its numerics) and raises
    NotImplementedError naming slice 10d and ROADMAP.md for a
    mixture-of-experts model; so does the mixture-of-experts
    global-dispatch ablation under "full" (naming ROADMAP.md); ZeRO-1, an
    fp8 ZeRO gather and a mixture-of-experts model (per-sample dispatch)
    under "full" build, in the step and the loop (tests/test_torch_zero.py
    trains them); an fp8 wire with an active model dim is refused by
    build, as in the reference; under fp8_ef (per rank in the reference
    too) the mixture-of-experts model trains, its replicas equal."""
    out = dp["ranks"][0]["refusals"]
    for name in ("zero1", "fp8_gather", "loop_zero1", "moe_full", "tp"):
        assert out[name] is None, (name, out[name])
    assert out["tp_moe"] is not None and "slice 10d" in out["tp_moe"]
    for name in ("tp_moe", "moe_global_dispatch_full"):
        assert out[name] is not None and "ROADMAP.md" in out[name], name
    for r in dp["ranks"]:
        assert np.isfinite(r["refusals"]["tp_step_loss"])
    assert "moe_per_sample_dispatch=False" in \
        out["moe_global_dispatch_full"]
    assert out["fp8_tp_build"] is not None
    assert np.isfinite(out["moe_fp8_ef_loss"])
    for r in dp["ranks"][1:]:
        a, b = leaves(out["moe_fp8_ef_master"]), \
            leaves(r["refusals"]["moe_fp8_ef_master"])
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_train_loop_resumes_bit_for_bit(dp):
    """The reference's test_wire_error_checkpoint_roundtrip at 2 ranks:
    the launcher's TrainLoop on the fp8 wire, 4 steps against 2, a
    restore and 2: master weights, optimizer state, ScaleState and each
    rank's residual bit for bit (the residual is checkpointed stacked,
    rank 0 writing, each rank restoring its slot). A resumed run whose
    residual restore is skipped (zeros) must differ. Records carry the
    comm/* bytes and the sampled allreduce span; meta the plan."""
    for r in dp["ranks"][:2]:
        loop = r["loop"]
        assert loop["last_step"] == (4, 4)
        full, resumed, faulty = loop["full"], loop["resumed"], \
            loop["faulty"]
        assert isinstance(faulty, dict), faulty
        for part in ("master", "opt", "err"):
            a, b = leaves(full[part]), leaves(resumed[part])
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        for x, y in zip(full["ss"], resumed["ss"]):
            np.testing.assert_array_equal(x, y)
        assert any(float(np.abs(v).max()) > 0
                   for v in leaves(full["err"]).values())
        same = all(np.array_equal(a, b) for a, b in zip(
            leaves(full["err"]).values(), leaves(faulty["err"]).values()))
        assert not same
        assert loop["meta_dist"]["compresses"]
        rec = loop["records"][0]
        assert rec["comm/sent_payload_bytes"] >= rec["comm/bytes_fp8_ef"] > 0
        assert rec["comm/ratio_fp8_vs_bf16"] <= 0.55
        assert "span/allreduce_s" in rec
    a, b = leaves(dp["ranks"][0]["loop"]["full"]["err"]), \
        leaves(dp["ranks"][1]["loop"]["full"]["err"])
    assert any(not np.array_equal(a[k], b[k]) for k in a)


def test_a_stop_on_one_rank_stops_both(dp):
    """Under a plan the loop's stop flag (set by SIGTERM / SIGINT) is
    read once a step and MAX-combined over the ranks: raised on rank 1
    alone during step 0's record (after that step's reading), both ranks
    stop after step 1 (a rank that ran on would wait forever in the next
    collective)."""
    assert [r["stop_last_step"] for r in dp["ranks"][:2]] == [2, 2]
