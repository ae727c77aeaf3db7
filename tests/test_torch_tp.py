"""The port's tensor parallelism in the training step (`distributed.
tensor_parallel`, the TP sites of `core.qlinear`, the head-sharded
attention, the vocab-parallel embedding, head and cross-entropy,
`ParallelPlan`'s TP layout, `make_train_step` / `TrainLoop` under a plan
with a 'model' dim) against one process and against `repro`.

The reference's tensor parallelism is GSPMD, so its numerics are those of
the one-device program: a rank group on a 'model' dim must compute what
one process computes on the same global batch. One module fixture runs
everything at once: four port ranks (tests/torch_dp_worker.py in its `tp`
mode, gloo on FileStores, one intra-op thread each, no jax) on a (1, 4)
mesh (the misaligned heads: wk's 32 columns over 4 ranks are half a head)
and a (2, 2) mesh (ZeRO-1 on and off), then ranks 0 and 1 on (1, 2) while
ranks 2 and 3 run the one-process steps; and one reference subprocess,
its one-device step on pallas_interpret.

Model and batches are tests/test_torch_distributed.py's tiny qwen2 (2
layers, d_model 64, 4 heads, 2 kv heads, vocab 512; qwen2's tied table and
QKV bias) on 8 x 32 global batches, under hybrid delayed scaling on the
fused path (the kernels' plain versions) with track_health, every rounding
RNE unless the case is SR; the paper recipe on the unfused path.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models.registry import build_config as j_build_config
from repro.models.transformer import init_lm
from test_torch_distributed import (CFG_KW, LOSS_REL, UPDATE_REL_L2,
                                    global_batches, leaves, leaves_t,
                                    rel_l2)

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 600
# The first step against one process: the loss within TP_LOSS_REL (the
# ranks' f32 sums add in another order than one process's accumulation);
# every site's first amax within one e5m2 notch (the coarser grid's
# ratio, 1.25); the update of the master weights within TP_UPDATE_TOL rel
# L2. Readings on the CPU: every fault-free case reads loss rel 0 and amax
# ratios 1.0, its update rel L2 0 on the 'model'-only meshes and 1.05e-2 on
# (2, 2) (the 'data' sums of the "full" step add in another order than one
# process's accumulation); the planted quantize-then-sum fault reads an
# update rel L2 of 0.458 (amax ratios 0.8 to 1.43), the local-amax fault
# amax ratios down to 0.5 (test_planted_faults_are_seen).
TP_LOSS_REL = 1e-4
NOTCH = 1.25 + 1e-6
TP_UPDATE_TOL = 0.1
CASES = {  # run -> (its one-process run, compared health pairs)
    "1x2": ("rne", True), "1x2/sr": ("sr", True), "1x4": ("rne", False),
    "2x2/zero": ("rne", False), "2x2/nozero": ("rne", False),
    "1x2/paper": ("paper", False), "1x2/mb2": ("mb2", False)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for this file (the suite runs
    in several worker processes on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_cfg():
    from repro.core.precision_policy import QuantConfig as JQuantConfig
    cfg = j_build_config("qwen2-1.5b", smoke=True).replace(
        scan_layers=False, **CFG_KW)
    q = JQuantConfig(recipe="hybrid", scaling="delayed",
                     backend="pallas_interpret", track_health=True,
                     act_rounding="rne", error_rounding="rne",
                     grad_rounding="rne")
    return cfg.replace(policy=dataclasses.replace(cfg.policy, quant=q))


REF_SCRIPT = """
import functools, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.scaling import DelayedScaling, discover_lm_sites
from repro.train.step import make_optimizer_for, make_train_step

with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
jax.config.update("jax_platform_name", "cpu")
jit = functools.partial(jax.jit, compiler_options={
    "xla_allow_excess_precision": False})
cfg = inp["jcfg"]
params = jax.tree_util.tree_map(jnp.asarray, inp["params"])
reg = discover_lm_sites(cfg, params, {
    k: jnp.asarray(v) for k, v in inp["probe"].items()})
ds = DelayedScaling(reg, qcfg=cfg.policy.quant)
opt = make_optimizer_for(cfg, learning_rate=1e-3)
b = {k: jnp.asarray(v) for k, v in inp["batches"][0].items()}
(state, ss), m = jit(make_train_step(cfg, opt, scaling=ds))(
    opt.init(params), ds.init(), b, jax.random.PRNGKey(0))
with open(sys.argv[2], "wb") as f:
    pickle.dump(dict(loss=float(m["loss"]),
                     master=jax.tree_util.tree_map(np.asarray,
                                                   state.master)), f)
"""


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """Runs the four ranks and the reference subprocess; returns their
    results."""
    import repro_torch
    work = tmp_path_factory.mktemp("tp")
    jcfg = jax_cfg()
    params = jax.tree_util.tree_map(np.asarray,
                                    init_lm(jax.random.PRNGKey(0), jcfg))
    batches = global_batches()[:2]
    inp = dict(cfg_kw=CFG_KW, params=params, batches=batches,
               probe={k: v[:1] for k, v in batches[0].items()})
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    with open(work / "ref_in.pkl", "wb") as f:
        pickle.dump(dict(inp, jcfg=jcfg), f)
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_SCRIPT),
         str(work / "ref_in.pkl"), str(work / "ref_out.pkl")],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    wenv = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen(
        [sys.executable, str(Path(__file__).with_name("torch_dp_worker.py")),
         str(r), str(work), "tp"], env=wenv, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    logs = []
    try:
        for p in ranks:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
        ref_err = ref.communicate(timeout=RANK_TIMEOUT)[1]
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
    solo = dict(out[2]["solo"], **out[3]["solo"])
    return dict(ranks=out, solo=solo, ref=ref_res, inp=inp)


def group_ranks(tp, run):
    """The ranks that ran `run` (every rank of its mesh)."""
    return [r for r in tp["ranks"] if run in r["runs"]]


def update_rel(got, want, p0):
    """rel L2 of one master-weight update against another, from `p0`."""
    g, w, z = leaves(got), leaves(want), leaves(p0)
    ks = sorted(w)
    assert sorted(g) == ks
    return rel_l2([g[k].astype(np.float32) - z[k] for k in ks],
                  [w[k].astype(np.float32) - z[k] for k in ks])


def first_amax_ratio(got, want):
    a, b = got["amax"][0], want["amax"][0]
    assert got["keys"] == want["keys"]
    assert ((a > 0) == (b > 0)).all()
    return a[a > 0] / b[a > 0]


def health(m):
    return {k: np.asarray(v) for k, v in m.items()
            if k.startswith("health/") and k not in ("health/amax_sites",
                                                     "health/scale_churn")}


def test_ranks_import_no_jax(tp):
    assert not any(r["jax_loaded"] for r in tp["ranks"])


@pytest.mark.parametrize("run", sorted(CASES))
def test_first_step_equals_one_process(tp, run):
    """Every rank's first TP step against one process on the same global
    batch, weights and generator seed: the loss within TP_LOSS_REL, every
    site's first amax within one notch, the update within TP_UPDATE_TOL;
    on (1, 2) under RNE and SR the health pairs equal (to the f32
    rounding of a mean)."""
    key, pairs = CASES[run]
    want = tp["solo"][key]
    rs = group_ranks(tp, run)
    assert len(rs) == (2 if run.startswith("1x2") else 4)
    for r in rs:
        got = r["runs"][run]
        lg, lw = got["metrics"][0]["loss"], want["metrics"][0]["loss"]
        assert abs(lg - lw) <= TP_LOSS_REL * abs(lw), (lg, lw)
        assert got["metrics"][0]["grads_finite"]
        if want["keys"] is not None:
            ratio = first_amax_ratio(got, want)
            assert ratio.min() >= 1 / NOTCH and ratio.max() <= NOTCH
        u = update_rel(got["masters"][0], want["masters"][0], want["p0"])
        assert u < TP_UPDATE_TOL, u
        if pairs:
            hg, hw = health(got["metrics"][0]), health(want["metrics"][0])
            assert sorted(hg) == sorted(hw) and len(hg) > 0
            for k in hw:
                # A shard's pairs are averaged over the ranks: the whole
                # payload's fractions up to the f32 rounding of the mean.
                np.testing.assert_allclose(hg[k], hw[k], rtol=1e-6, atol=0,
                                           err_msg=k)


def test_first_step_against_reference(tp):
    """The (1, 2) TP step against the reference's one-device step on
    pallas_interpret, from the same weights (carried across by
    `from_jax_params`): the loss within LOSS_REL, the update within
    UPDATE_REL_L2 (tests/test_torch_distributed.py's limits)."""
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.registry import build_config
    from repro_torch.optim.optimizers import tmap
    cfg = build_config("qwen2-1.5b", smoke=True, **CFG_KW)
    want = tmap(lambda v: v.float().numpy(), from_jax_params(
        tp["ref"]["master"], cfg, device="cpu"))
    for r in group_ranks(tp, "1x2"):
        got = r["runs"]["1x2"]
        lg = got["metrics"][0]["loss"]
        assert abs(lg - tp["ref"]["loss"]) <= LOSS_REL * abs(tp["ref"]["loss"])
        u = update_rel(got["masters"][0], want, tp["solo"]["rne"]["p0"])
        assert u < UPDATE_REL_L2, u


@pytest.mark.parametrize("case", [f"{a}/{q}" for a in (
    "codeqwen1.5-7b", "internlm2-20b", "mistral-large-123b",
    "llava-next-34b") for q in ("rne", "paper")])
def test_dense_configs_train_under_tp(tp, case):
    """The other dense configs of the slice (smoke width, 2 layers; llava
    with its patch prefix) under both recipes: one (1, 2) TP step against
    one process, the loss within TP_LOSS_REL and the update within
    TP_UPDATE_TOL, on both ranks."""
    for r in tp["ranks"][:2]:
        got = r["archs"][case]
        assert abs(got["loss_tp"] - got["loss_one"]) \
            <= TP_LOSS_REL * abs(got["loss_one"]), got
        assert got["update_rel"] < TP_UPDATE_TOL, got


def test_zero_on_equals_off_bitwise(tp):
    """(2, 2) with wire "full": ZeRO-1 on against off, both steps, bit for
    bit (the masters gathered whole, the loss, the ScaleState)."""
    for r in group_ranks(tp, "2x2/zero"):
        on, off = r["runs"]["2x2/zero"], r["runs"]["2x2/nozero"]
        for a, b in zip(on["masters"], off["masters"]):
            for k, v in leaves(a).items():
                np.testing.assert_array_equal(v, leaves(b)[k], err_msg=k)
        assert [m["loss"] for m in on["metrics"]] == \
            [m["loss"] for m in off["metrics"]]
        np.testing.assert_array_equal(on["scale"], off["scale"])


def test_remat_bitwise_under_tp(tp):
    """remat=True (each layer recomputed in the backward) equals
    remat=False under TP, both steps, bit for bit."""
    for r in group_ranks(tp, "1x2"):
        a, b = r["runs"]["1x2/remat"], r["runs"]["1x2"]
        for x, y in zip(a["masters"], b["masters"]):
            for k, v in leaves(x).items():
                np.testing.assert_array_equal(v, leaves(y)[k], err_msg=k)
        assert [m["loss"] for m in a["metrics"]] == \
            [m["loss"] for m in b["metrics"]]
        for x, y in zip(a["amax"], b["amax"]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fault", ["qsum", "local_amax"])
def test_planted_faults_are_seen(tp, fault):
    """Quantizing each rank's row-parallel partial before the sum, or
    keeping each rank's own amaxes, leaves the limits that the fault-free
    step keeps: the update beyond TP_UPDATE_TOL or an amax beyond the
    notch, on some rank."""
    want = tp["solo"]["rne"]
    seen = []
    for r in group_ranks(tp, "1x2/" + fault):
        got = r["runs"]["1x2/" + fault]
        ratio = first_amax_ratio(got, want)
        u = update_rel(got["masters"][0], want["masters"][0], want["p0"])
        seen.append(u >= TP_UPDATE_TOL or ratio.min() < 1 / NOTCH
                    or ratio.max() > NOTCH)
    assert any(seen), seen


def test_replicated_state_is_equal_across_ranks(tp):
    """In every run the master leaves TP leaves whole (the norm scales),
    the loss scale and the ScaleState hold the same bytes on every rank of
    a 'model' group (under ZeRO-1, of the same 'data' shard), and the loss
    is the same."""
    for run in CASES:
        rs = group_ranks(tp, run)
        for r in rs:
            a, b = next(x["runs"][run] for x in rs
                        if x["runs"][run]["dp_rank"]
                        == r["runs"][run]["dp_rank"]), r["runs"][run]
            assert sorted(a["local_repl"]) == sorted(b["local_repl"])
            assert a["local_repl"]
            for k, v in a["local_repl"].items():
                np.testing.assert_array_equal(v, b["local_repl"][k],
                                              err_msg=k)
            for k, v in a["loss_scale"].items():
                np.testing.assert_array_equal(v, b["loss_scale"][k])
            if a["scale"] is not None:
                np.testing.assert_array_equal(a["scale"], b["scale"])
            assert [m["loss"] for m in a["metrics"]] == \
                [m["loss"] for m in b["metrics"]]


def test_tp_bytes_against_model(tp):
    """The bytes a (1, 2) rank sent over 'model' in its two steps, counted
    by `distributed.comm` as "tp", against `step_bytes_model`: at least
    the model, the rest the observation vectors and the grad norm's
    floats."""
    from repro_torch.distributed.tensor_parallel import step_bytes_model
    for r in group_ranks(tp, "1x2"):
        sent = r["runs"]["1x2"]["sent"]
        model = 2 * step_bytes_model(CFG_KW["n_layers"], CFG_KW["d_model"],
                                     8 * 32, 2)
        assert model <= sent["tp"] <= 1.05 * model, (sent, model)
        assert set(sent) == {"tp"}


def test_vocab_parallel_embedding_and_ce(tp):
    """The vocab-parallel lookup equals the whole table's bit for bit, and
    its table gradient is the whole gradient's rows; the vocab-parallel
    cross-entropy's sum and dh within 1e-6 (rel) of the whole head's; the
    tied table's gradient (head and lookup rows) the whole one's rows."""
    for r in tp["ranks"][:2]:
        v = r["vocab"]
        lo, hi = v["rows"]
        t, w = v["tp"], v["whole"]
        np.testing.assert_array_equal(t["embed"], w["embed"])
        np.testing.assert_array_equal(t["embed_grad"],
                                      w["embed_grad"][lo:hi])
        assert abs(t["ce"] - w["ce"]) <= 1e-6 * abs(w["ce"])
        assert rel_l2([t["dh"]], [w["dh"]]) <= 1e-6
        assert rel_l2([t["table_grad"]], [w["table_grad"][lo:hi]]) <= 1e-6


def test_train_loop_resume_and_restore(tp):
    """TrainLoop under the (1, 2) plan: 4 steps equal 2 + a restore + 2 bit
    for bit (master, moments, ScaleState); the checkpoint holds whole
    arrays; one process restores it bit for bit."""
    for r in tp["ranks"][:2]:
        lp = r["loops"]
        full, res = lp["full"], lp["resumed"]
        assert full["last"] == res["last"] == 4
        for part in ("master", "opt"):
            a, b = leaves(full[part]), leaves(res[part])
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(full["ss"], res["ss"])
    a, b = tp["ranks"][0]["loops"], tp["ranks"][1]["loops"]
    for k, x in a["full"]["repl"].items():
        np.testing.assert_array_equal(x, b["full"]["repl"][k])
    solo = a["solo_restore"]
    for part in ("master", "opt"):
        x, y = leaves(a["full"][part]), leaves(solo[part])
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    shapes = a["ckpt_shapes"]
    table = [s for k, s in shapes.items() if "embed" in k and "table" in k]
    assert table and all(s == (512, CFG_KW["d_model"]) for s in table)


def _tp_plan():
    from repro_torch.core.precision_policy import DistConfig
    from repro_torch.distributed.strategy import (ParallelPlan,
                                                  TensorParallel)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 mesh=torch.arange(2).reshape(1, 2))
    return ParallelPlan(mesh, DistConfig(zero1=False), None, None,
                        TensorParallel())


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "recurrentgemma-9b",
                                  "xlstm-125m", "paper-transformer",
                                  "seamless-m4t-large-v2", "jit_amax",
                                  "delayed_unfused"])
def test_out_of_scope_is_refused(arch):
    """Under a TP plan the families of slice 10d and the options outside
    this slice's scope raise NotImplementedError naming ROADMAP.md and
    slice 10d (step and loop); the dense configs build."""
    from repro_torch.core.precision_policy import QuantConfig
    from repro_torch.models.registry import build_config
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.step import make_optimizer_for, make_train_step
    plan = _tp_plan()
    if arch in ("jit_amax", "delayed_unfused"):
        cfg = build_config("qwen2-1.5b", smoke=True)
        q = QuantConfig(scaling="jit_amax") if arch == "jit_amax" else \
            QuantConfig(recipe="hybrid", scaling="delayed", backend="xla")
        cfg = cfg.replace(policy=dataclasses.replace(cfg.policy, quant=q))
    else:
        cfg = build_config(arch, smoke=True)
    opt = make_optimizer_for(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as e:
        make_train_step(cfg, opt, plan=plan, device="cpu")
    assert "slice 10d" in str(e.value)
    with pytest.raises(NotImplementedError, match="slice 10d"):
        TrainLoop(cfg, opt, iter(()), LoopConfig(), plan=plan, device="cpu")
    for arch in ("qwen2-1.5b", "codeqwen1.5-7b", "internlm2-20b",
                 "mistral-large-123b", "llava-next-34b"):
        dense = build_config(arch, smoke=True)
        assert callable(make_train_step(dense, make_optimizer_for(dense),
                                        plan=plan, device="cpu"))


def test_fp8_wire_with_a_model_dim_is_refused_by_build():
    """build refuses fp8_ef and the fp8 ZeRO gather with an active model
    dim, as the reference's does."""
    from repro_torch.core.precision_policy import DistConfig
    from repro_torch.distributed.strategy import ParallelPlan

    class Mesh:
        mesh_dim_names = ("data", "model")
        mesh = torch.arange(4).reshape(2, 2)
    for kw in ({"wire": "fp8_ef"}, {"wire_zero_gather": "fp8"}):
        with pytest.raises(NotImplementedError):
            ParallelPlan.build(Mesh(), DistConfig(**kw))
    assert ParallelPlan.build(Mesh(), DistConfig()).tp_size == 2


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_plan_layout_is_the_reference(shape):
    """`describe()` is the reference plan's, field for field; the TP dims
    are the 'model' entries of the reference's param specs and the ZeRO
    dims the 'data' entries of its zero1 specs, picked on the whole shape
    among the dims TP leaves whole; `shard_leaves` over 'model', then
    'data', of the whole tree, and `unshard_leaves` back, round-trip."""
    from repro.core.precision_policy import DistConfig as JDistConfig
    from repro.distributed import sharding as jsharding
    from repro.distributed import strategy as jstrategy
    from repro_torch.core.precision_policy import DistConfig
    from repro_torch.distributed import sharding
    from repro_torch.distributed import strategy
    from repro_torch.models.convert import shard_leaves, unshard_leaves
    d, m = shape
    sizes = {"data": d, "model": m}
    jmesh = types.SimpleNamespace(shape=dict(sizes), axis_names=("data",
                                                                 "model"))
    jplan = jstrategy.ParallelPlan.build(jmesh, JDistConfig())
    plan = strategy.ParallelPlan.build(types.SimpleNamespace(
        mesh_dim_names=("data", "model"),
        mesh=torch.arange(d * m).reshape(d, m)), DistConfig())
    assert plan.describe() == jplan.describe()
    jcfg = jax_cfg()
    shapes = jax.eval_shape(lambda k: init_lm(k, jcfg),
                            jax.random.PRNGKey(0))
    jspec = jsharding.zero1_specs(shapes, jsharding.param_specs(
        shapes, jmesh), jmesh)
    want = {k: tuple(s) for k, s in leaves_t(jax.tree_util.tree_map(
        lambda s: s, jspec, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))).items()}
    whole = {k: torch.arange(int(np.prod(x.shape)), dtype=torch.float32)
             .reshape(x.shape) for k, x in leaves_t(shapes).items()}
    tree = {}
    for k, x in whole.items():
        node = tree
        parts = k.strip("/").split("/")
        for p_ in parts[:-1]:
            node = node.setdefault(p_, {})
        node[parts[-1]] = x
    tdims = plan.tp_dims(tree)
    zdims = sharding.zero1_specs(tree, plan.param_specs(tree), sizes)
    for k, s in leaves_t(zdims).items():
        entries = tuple(s) + (None,) * (len(whole[k].shape) - len(s))
        w = want[k] + (None,) * (len(whole[k].shape) - len(want[k]))
        assert entries == w, k
        td = leaves_t(tdims)[k]
        assert td == (w.index("model") if "model" in w else None), k
    zd = {k: sharding.dim_of(s, "data") for k, s in leaves_t(zdims).items()}
    zd_tree = _like(tree, zd)
    shards = [[shard_leaves(shard_leaves(tree, tdims, t, m), zd_tree, z, d)
               for z in range(d)] for t in range(m)]
    back = unshard_leaves([unshard_leaves(row, zd_tree) for row in shards],
                          tdims)
    for k, x in leaves_t(back).items():
        assert torch.equal(x, whole[k]), k
    assert any(v is not None for v in leaves_t(tdims).values())


def _like(tree, flat, pre=""):
    if isinstance(tree, dict):
        return {k: _like(v, flat, f"{pre}/{k}") for k, v in tree.items()}
    return flat[pre]


def test_attention_on_a_rank_heads_is_the_whole_slice():
    """Kernels 2-4's plain versions on a TP rank's heads (`heads=(H,
    h0)`: the SR hash reads the whole tensor's head index) equal the whole
    launch's slices under SR, forward and backward, on both ranks of a
    'model' dim of 2; without the offset rank 1's forward differs."""
    from repro_torch.kernels.fp8_attention import ops as at
    g = torch.Generator().manual_seed(2)
    b, h, hkv, s, d = 2, 6, 2, 64, 16
    q = torch.randn(b, h, s, d, generator=g).to(torch.float8_e4m3fn)
    k = torch.randn(b, hkv, s, d, generator=g).to(torch.float8_e4m3fn)
    v = torch.randn(b, hkv, s, d, generator=g).to(torch.float8_e4m3fn)
    do = torch.randn(b, h, s, d, generator=g).to(torch.float8_e5m2)
    fscal = [0.25, 1.0, 1.0, 1.0]
    bscal = [0.25, 1.0, 1.0, 1.0, 1.0, 1.0, 0.25, 1.0, 1.0, 1.0]
    kw = dict(fmt_s="e4m3", fmt_p="e4m3", rounding_s="sr", rounding_p="sr")
    bkw = dict(kw, fmt_e="e5m2", rounding_e="sr")
    wf = at.fp8_attention_fwd(q, k, v, 7, fscal, **kw)
    wb = at.fp8_attention_bwd(q, k, v, do, 7, bscal, **bkw)
    for r in range(2):
        hq, hk = slice(3 * r, 3 * r + 3), slice(r, r + 1)
        f = at.fp8_attention_fwd(q[:, hq], k[:, hk], v[:, hk], 7, fscal,
                                 heads=(h, 3 * r), **kw)
        bb = at.fp8_attention_bwd(q[:, hq], k[:, hk], v[:, hk], do[:, hq],
                                  7, bscal, heads=(h, 3 * r), **bkw)
        assert torch.equal(f[0], wf[0][:, hq])
        for got, want in zip(bb[:3], (wb[0][:, hq], wb[1][:, hk],
                                      wb[2][:, hk])):
            assert torch.equal(got, want)
    fault = at.fp8_attention_fwd(q[:, 3:], k[:, 1:], v[:, 1:], 7, fscal,
                                 **kw)[0]
    assert not torch.equal(fault, wf[0][:, 3:])


def test_tp_group_reads_the_step_layout():
    """The layers ask the active group which weights are split
    (`TPGroup.dim_of`); it answers from the layout the step hands it
    (`with_layout`: leaf identity -> its TP dim, from
    `ParallelPlan.tp_dims`), not from shapes: a leaf of a split leaf's
    shape that the layout keeps whole reads None, and a function of one
    leaf alone (the tied table's transpose in the head) reads its
    leaf's dim."""
    from repro_torch.distributed.tensor_parallel import TPGroup
    split, whole = (torch.zeros(4, 6, requires_grad=True) for _ in range(2))
    table = torch.zeros(8, 4, requires_grad=True)
    tp = TPGroup(None, 0, 2).with_layout([(split, 1), (whole, None),
                                          (table, 0)])
    assert tp.dim_of(split) == 1
    assert tp.dim_of(whole) is None
    assert tp.dim_of(table) == 0 and tp.dim_of(table.t()) == 0
    assert tp.dim_of(torch.zeros(4, 6)) is None
    assert TPGroup(None, 0, 2).dim_of(split) is None
