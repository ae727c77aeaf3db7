"""The port's trainer: `train.step` with `track_health` and gradient
accumulation against `repro`, and the training loop, checkpoint/resume,
preemption, stragglers and the launchers against themselves, on the CPU
at smoke size (2 layers, d_model 64, heads 4 / 2, vocab 64; torch on one
intra-op thread).

(a) One fused hybrid-delayed all-RNE step with `track_health` and
    `n_microbatches=2`, the reference on `pallas_interpret` (compiled
    without XLA's excess precision, as in tests/test_torch_train_step.py)
    and the port on the plain versions, from the same weights and batch:
    the `health/*` keys equal; the loss within the step limit of
    tests/test_torch_train_step.py; the [sat, flush] pairs of the forward
    sites (classes A and W: operands, outputs, S and P) bit for bit; those
    of the backward sites (E and G) each within BWD_REL of its own
    magnitude plus BWD_FLOOR (two implementations' backward passes part by
    the few gradient values a summation order moves across a format
    boundary: read 16 values of a site's 4096 at most, wq#E's flush
    0.0352 against 0.0391); the amax vector within one grid notch a site.
    Planted faults must be caught: the microbatch observations summed, not
    max-combined; one backward site's pair (kernel 3's dS counts) or one
    forward site's (kernel 2's P counts) dropped. The per-op health values
    are held bit for bit in tests/test_torch_health.py.
(b) The loop: 4 steps uninterrupted equal, bit for bit, 2 steps, a restore
    and 2 more (master weights, optimizer and loss-scale state, ScaleState,
    every record's loss, the health pairs); preemption checkpoints and
    stops; a slow step is counted as a straggler; the launcher runs
    (`python -m repro_torch.launch.train --device cpu --smoke --steps 3`);
    `launch/serve.py --ckpt-dir` restores params; the refusals that stay.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.fp8_attention.ops  # noqa: F401  (jitted before patching)
import repro.kernels.fused_quant_matmul.ops  # noqa: F401
from repro.core.precision_policy import PrecisionPolicy, QuantConfig
from repro.models.config import ModelConfig
from repro.models.transformer import init_lm
from repro.scaling import DelayedScaling, discover_lm_sites
from repro.train.step import make_optimizer_for, make_train_step
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import precision_policy as tpp
from repro_torch.core.loss_scale import LossScaler
from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
from repro_torch.models import config as tmc
from repro_torch.models.convert import from_jax_params
from repro_torch.models.transformer import init_lm as t_init_lm
from repro_torch.obs.health import HealthConfig
from repro_torch.optim.optimizers import tmap
from repro_torch.scaling import context as scale_ctx
from repro_torch.scaling.calibrate import discover_lm_sites as t_discover
from repro_torch.scaling.state import DelayedScaling as TDelayedScaling
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.step import make_optimizer_for as t_make_optimizer_for
from repro_torch.train.step import make_train_step as t_make_train_step

jax.config.update("jax_platform_name", "cpu")

PER_OP = {"xla_allow_excess_precision": False}
RNE = dict(act_rounding="rne", error_rounding="rne", grad_rounding="rne")
KW = dict(arch="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          d_ff=128, vocab_size=64, max_seq_len=64)
LOSS_REL = 1e-2          # tests/test_torch_train_step.py's step limit
# A backward site's pair: within BWD_REL of its larger side plus two values
# of the 4096 a microbatch's (2, 32, 64) site holds.
BWD_REL = 0.2
BWD_FLOOR = 2.0 ** -11


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(rounding="rne", track=True):
    rd = RNE if rounding == "rne" else {}
    q = tpp.QuantConfig(recipe="hybrid", scaling="delayed", backend="pallas",
                        track_health=track, **rd)
    return tmc.ModelConfig(policy=tpp.PrecisionPolicy(quant=q), remat=False,
                           **KW)


def batch_of(batch_size=4, seq=32, step=0):
    return next(synthetic_lm_batches(DataConfig(
        vocab_size=64, seq_len=seq, batch_size=batch_size), start_step=step))


# ---------------------------------------------------------------------------
# (a) the step against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_step():
    """The reference's step (hybrid, delayed, track_health, all-RNE,
    n_microbatches=2) on pallas_interpret, and the port's pieces at the
    same weights and batch."""
    jq = QuantConfig(recipe="hybrid", scaling="delayed",
                     backend="pallas_interpret", track_health=True, **RNE)
    jcfg = ModelConfig(policy=PrecisionPolicy(quant=jq), remat=False,
                       scan_layers=False, **KW)
    tcfg = port_cfg()
    jp = init_lm(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    batch = batch_of()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", functools.partial(jax.jit,
                                                 compiler_options=PER_OP))
        reg = discover_lm_sites(jcfg, jp, {k: v[:2] for k, v in jb.items()})
        ds = DelayedScaling(reg, qcfg=jq)
        opt = make_optimizer_for(jcfg, learning_rate=1e-3)
        (_, _), met = jax.jit(make_train_step(
            jcfg, opt, n_microbatches=2, scaling=ds))(
                opt.init(jp), ds.init(), jb, jax.random.PRNGKey(0))
    return dict(tcfg=tcfg, tp=tp, batch=batch, reg=reg,
                met=jax.tree_util.tree_map(np.asarray, met))


def port_step(s):
    tcfg = s["tcfg"]
    reg = t_discover(tcfg, s["tp"], {k: v[:2] for k, v in s["batch"].items()})
    assert reg.keys == s["reg"].keys
    ds = TDelayedScaling(reg, qcfg=tcfg.policy.quant)
    opt = t_make_optimizer_for(tcfg, learning_rate=1e-3)
    step = t_make_train_step(tcfg, opt, scaling=ds, n_microbatches=2,
                             device="cpu")
    (_, _), met = step(opt.init(s["tp"]), ds.init(), s["batch"],
                       torch.Generator().manual_seed(0))
    return met, reg


def health_faults(want, got):
    """The `health/<site>` keys whose pairs part beyond the limits: forward
    sites (A, W) bit for bit, backward sites (E, G) per entry within
    BWD_REL of the larger side plus BWD_FLOOR."""
    bad = []
    for k in want:
        if not k.startswith("health/") or k in ("health/amax_sites",
                                                 "health/scale_churn"):
            continue
        w = np.asarray(want[k], np.float64)
        g = np.asarray(got[k], np.float64)
        if k[-1] in "AW":
            ok = np.array_equal(w, g)
        else:
            ok = bool(np.all(np.abs(w - g) <= BWD_REL * np.maximum(w, g)
                             + BWD_FLOOR))
        if not ok:
            bad.append(k)
    return bad


def test_step_health_keys_and_values_match_reference(ref_step):
    want = ref_step["met"]
    got, reg = port_step(ref_step)
    keys = {k for k in want if k.startswith("health/")}
    assert keys == {k for k in got if k.startswith("health/")}
    assert len(keys) == len(reg) + 2
    assert abs(got["loss"] - float(want["loss"])) \
        <= LOSS_REL * abs(float(want["loss"]))
    assert got["grads_finite"] == bool(want["grads_finite"])
    assert health_faults(want, got) == []
    for key, a, b in zip(reg.keys, want["health/amax_sites"],
                         got["health/amax_sites"]):
        man = 3 if reg.class_letter(key) in ("W", "A") else 2
        lo, hi = sorted((float(a), float(b)))
        assert a == b or (lo > 0 and hi / lo <= 1 + 2.0 ** -man + 1e-6), key
    assert 0.0 <= got["health/scale_churn"] <= 1.0


def test_planted_microbatch_fault_exceeds_limit(ref_step, monkeypatch):
    def summed(ctxs):
        out = scale_ctx.ScaleContext(mode="collect", scales=ctxs[0].scales,
                                     bwd_uses=dict(ctxs[0].bwd_uses))
        for name in ("collected", "collected_bwd", "health", "health_bwd"):
            merged = getattr(out, name)
            for ctx in ctxs:
                for k, v in getattr(ctx, name).items():
                    merged[k] = merged[k] + v if k in merged else v
        return out
    monkeypatch.setattr(scale_ctx, "combine_microbatches", summed)
    got, _ = port_step(ref_step)
    assert health_faults(ref_step["met"], got) != []


@pytest.mark.parametrize("method,site", [
    ("record_bwd_health", "decoder/layer_1/attn/sdpa#ds.E"),
    ("record_health", "decoder/layer_0/attn/sdpa#p.A")], ids=["dS", "P"])
def test_planted_site_fault_is_caught(ref_step, monkeypatch, method, site):
    """One site's counts dropped (its pair recorded as zeros): that site,
    and only it, fails the limits."""
    orig = getattr(scale_ctx.ScaleContext, method)

    def dropped(self, key, frac2):
        return orig(self, key, torch.zeros_like(frac2) if key == site
                    else frac2)
    monkeypatch.setattr(scale_ctx.ScaleContext, method, dropped)
    got, _ = port_step(ref_step)
    assert health_faults(ref_step["met"], got) == ["health/" + site]


def test_microbatches_accumulate_like_one_batch():
    """Two microbatches of one repeated half equal one step on that half:
    gradients g / 2 + g / 2 in f32, observations max-combined (equal),
    losses averaged (equal) — without SR, each pass is the same."""
    tcfg = port_cfg()
    half = batch_of(batch_size=2)
    twice = {k: np.concatenate([v, v]) for k, v in half.items()}
    tp = t_init_lm(tcfg, seed=0, device="cpu")
    reg = t_discover(tcfg, tp, half)
    ds = TDelayedScaling(reg, qcfg=tcfg.policy.quant)
    runs = []
    for n, b in ((1, half), (2, twice)):
        opt = t_make_optimizer_for(tcfg, learning_rate=1e-3)
        state = opt.init(tmap(lambda p: p.clone(), tp))
        (state, ss), met = t_make_train_step(
            tcfg, opt, scaling=ds, n_microbatches=n, device="cpu")(
                state, ds.init(), b, torch.Generator().manual_seed(0))
        runs.append((state, ss, met))
    (s1, ss1, m1), (s2, ss2, m2) = runs
    assert m1["loss"] == m2["loss"]
    assert np.array_equal(ss1.amax_history, ss2.amax_history)
    for k in m1:
        if k.startswith("health/"):
            assert np.array_equal(np.asarray(m1[k]), np.asarray(m2[k])), k
    flat1, flat2 = _flat(s1.master), _flat(s2.master)
    assert all(torch.equal(flat1[k], flat2[k]) for k in flat1)


def test_refusals_that_stay():
    """A plan with tensor parallelism is refused by the step and the loop
    for a slice-10d family (a mixture-of-experts model), naming ROADMAP.md
    and slice 10d; amax_sync, data-parallel plans
    (tests/test_torch_distributed.py), ZeRO-1 plans
    (tests/test_torch_zero.py) and TP plans for the dense decoders
    (tests/test_torch_tp.py) are ported: the step and the loop build
    with one."""
    import types

    from repro_torch.core.precision_policy import DistConfig
    from repro_torch.distributed.strategy import (DataParallel,
                                                  ParallelPlan,
                                                  TensorParallel,
                                                  ZeRO1Sharded)
    tcfg = port_cfg()
    opt = t_make_optimizer_for(tcfg)
    dp = DataParallel(("data",))
    mesh = types.SimpleNamespace(mesh_dim_names=("data",),
                                 mesh=torch.arange(2))
    zero1 = ParallelPlan(mesh, DistConfig(), dp, ZeRO1Sharded(), None)
    tp = ParallelPlan(mesh, DistConfig(zero1=False), dp, None,
                      TensorParallel())
    moe = tmc.ModelConfig(policy=tcfg.policy, remat=False, n_experts=4,
                          **KW)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        t_make_train_step(moe, opt, device="cpu", plan=tp)
    assert callable(t_make_train_step(tcfg, opt, device="cpu", plan=tp))
    assert callable(t_make_train_step(tcfg, opt, device="cpu", plan=zero1))
    assert callable(t_make_train_step(tcfg, opt, device="cpu",
                                      amax_sync=lambda v: v))
    # Recomputation no longer refuses (tests/test_torch_step_options.py
    # holds remat=True to remat=False bit for bit).
    assert callable(t_make_train_step(tcfg.replace(remat=True), opt,
                                      device="cpu"))
    with pytest.raises(NotImplementedError, match="slice 10d"):
        TrainLoop(moe, opt, iter(()), LoopConfig(), plan=tp, device="cpu")
    assert TrainLoop(tcfg, opt, iter(()), LoopConfig(), plan=tp,
                     device="cpu").sharded
    assert TrainLoop(tcfg, opt, iter(()), LoopConfig(), plan=zero1,
                     device="cpu").zero
    with pytest.raises(ValueError, match="microbatches"):
        t_make_train_step(tcfg, opt, n_microbatches=3, device="cpu")(
            opt.init(t_init_lm(tcfg, device="cpu")), batch_of(batch_size=4),
            torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# (b) the loop
# ---------------------------------------------------------------------------

def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def make_loop(tmp, total, *, rounding="sr", registry=None, metrics=None,
              every=2, batch_size=4):
    tcfg = port_cfg(rounding)
    opt = t_make_optimizer_for(tcfg, learning_rate=3e-3, scaler=LossScaler(
        mode="enhanced", init_scale=2.0 ** 13))
    if registry is None:
        registry = t_discover(tcfg, t_init_lm(tcfg, device="cpu"),
                              batch_of(batch_size=1))
    data_cfg = DataConfig(vocab_size=64, seq_len=32, batch_size=batch_size)

    def data(start):
        return synthetic_lm_batches(data_cfg, start_step=start)
    loop = LoopConfig(total_steps=total, checkpoint_every=every,
                      checkpoint_dir=str(tmp), log_every=100,
                      metrics_path=metrics, n_microbatches=2)
    return TrainLoop(tcfg, opt, data, loop, seed=3, health=HealthConfig(),
                     scaling=TDelayedScaling(registry,
                                             qcfg=tcfg.policy.quant),
                     device="cpu"), registry


def test_resume_is_bitwise_continuous(tmp_path):
    """4 steps in one loop equal 2 steps, a fresh loop's restore and 2
    more, bit for bit: every record's loss and health pairs, the master
    weights, the optimizer and loss-scale state, and the ScaleState (SR
    recipe: every step's generator is seeded from (seed, step))."""
    recs = {"full": [], "resumed": []}
    full, reg = make_loop(tmp_path / "a", 4)
    full.on_metrics = lambda s, r: recs["full"].append(r)
    out_full = full.run()
    first, _ = make_loop(tmp_path / "b", 2, registry=reg)
    first.on_metrics = lambda s, r: recs["resumed"].append(r)
    first.run()
    second, _ = make_loop(tmp_path / "b", 4, registry=reg)
    second.on_metrics = lambda s, r: recs["resumed"].append(r)
    out = second.run()
    assert out["last_step"] == out_full["last_step"] == 4
    drop = ("step_time_s", "span/", "stragglers")
    strip = [[{k: v for k, v in r.items() if not k.startswith(drop)}
              for r in recs[n]] for n in ("full", "resumed")]
    assert strip[0] == strip[1]
    a, b = out_full["state"], out["state"]
    for t1, t2 in ((a.master, b.master), (a.opt_state, b.opt_state),
                   (dataclasses.asdict(a.loss_scale),
                    dataclasses.asdict(b.loss_scale))):
        f1, f2 = _flat(t1), _flat(t2)
        assert f1.keys() == f2.keys()
        assert all(torch.equal(f1[k], f2[k]) for k in f1)
    for f in ("amax_history", "scale"):
        assert np.array_equal(getattr(out_full["scale_state"], f),
                              getattr(out["scale_state"], f))
    assert out_full["scale_state"].step == out["scale_state"].step == 4
    assert Checkpointer(tmp_path / "b").manifest()["step"] == 4


def test_preemption_checkpoints_and_stops(tmp_path):
    lp, _ = make_loop(tmp_path, 100, every=1000)
    orig = lp._step_fn
    calls = {"n": 0}

    def wrapped(*a):
        calls["n"] += 1
        if calls["n"] == 2:
            lp._stop = True   # a SIGTERM during step 1
        return orig(*a)
    lp._step_fn = wrapped
    out = lp.run()
    assert out["last_step"] == 2
    assert lp.ckpt.latest_step() == 2


def test_stragglers_are_counted_and_ride_the_manifest(tmp_path):
    import time
    mpath = tmp_path / "m.jsonl"
    lp, _ = make_loop(tmp_path / "ck", 6, every=3, metrics=str(mpath))
    hits = []
    lp.on_straggler = lambda step, dt: hits.append(step)
    lp.loop.straggler_factor = 1.5
    orig = lp._step_fn
    calls = {"n": 0}

    def wrapped(*a):
        calls["n"] += 1
        if calls["n"] == 5:
            time.sleep(1.0)
        return orig(*a)
    lp._step_fn = wrapped
    out = lp.run()
    assert out["stragglers"] >= 1 and 4 in hits
    extra = lp.ckpt.manifest()["extra"]
    assert extra["stragglers"] == out["stragglers"] and extra["straggler_ema"]
    lines = [json.loads(x) for x in mpath.read_text().splitlines()]
    meta = json.loads((tmp_path / "m.jsonl.meta.json").read_text())
    assert len(lines) == 6 and all(r["v"] == 1 for r in lines)
    assert meta["sites"] == list(lp.scaling.registry.keys)
    assert {"span/data_wait_s", "span/step_dispatch_s",
            "span/device_sync_s"} <= set(lines[0])
    assert "span/checkpoint_s" in lines[2]


def test_train_launcher_runs_on_the_cpu(tmp_path, capsys):
    """`python -m repro_torch.launch.train --device cpu --smoke --steps 3`
    (a wire-format flag is ignored on one device), then its `build_loop`
    under the hybrid recipe with health tracking and two microbatches;
    health tracking under the paper recipe is refused."""
    from repro_torch.launch import train
    out = train.main(["--device", "cpu", "--smoke", "--steps", "3",
                      "--ckpt-dir", str(tmp_path / "a"), "--wire", "fp8_ef"])
    assert out["last_step"] == 3 and np.isfinite(out["metrics"]["loss"])
    assert "wire format flags ignored" in capsys.readouterr().out
    out = train.build_loop(smoke=True, steps=2, batch=4, seq=32,
                           microbatches=2, recipe="hybrid", track_health=True,
                           ckpt_dir=str(tmp_path / "b"), device="cpu").run()
    n_health = sum(k.startswith("health/") for k in out["metrics"])
    assert out["last_step"] == 2 and n_health > 3
    with pytest.raises(ValueError, match="recipe='hybrid'"):
        train.build_loop(smoke=True, track_health=True, device="cpu")


def test_serve_restores_params_from_ckpt_dir(tmp_path, capsys):
    from repro_torch.launch import serve
    from repro_torch.models.registry import build_config
    cfg = build_config("qwen2-1.5b", smoke=True)
    saved = t_init_lm(cfg, seed=7, device="cpu")
    Checkpointer(tmp_path, async_save=False).save(5, saved)
    eng = serve.main(["--smoke", "--legacy", "--device", "cpu",
                      "--n-requests", "1", "--ckpt-dir", str(tmp_path)])
    assert "restored params at step 5" in capsys.readouterr().out
    got, want = _flat(eng.params), _flat(saved)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_train_lm_example_small_on_the_cpu(tmp_path):
    from repro.models.registry import build_config as j_build
    from repro_torch.examples import train_lm
    from repro_torch.models.registry import build_config
    out = train_lm.main(["--small", "--steps", "2", "--device", "cpu",
                         "--ckpt", str(tmp_path)])
    assert out["last_step"] == 2
    for arch in ("qwen2-1.5b", "paper-transformer"):
        for smoke in (False, True):
            assert build_config(arch, smoke=smoke).param_count() == \
                j_build(arch, smoke=smoke).param_count()
