"""ZeRO-1, the fp8 ZeRO gather and the "full" path's global batch
(`repro_torch.distributed.sharding`, `ParallelPlan`'s ZeRO bookkeeping and
`gather_params`, `make_train_step` / `TrainLoop` under ZeRO-1, the summed
weight-gradient Q nodes, `data.pipeline.microbatch_shard`, the
mixture-of-experts aux losses over the global batch) against
`repro.distributed` and `repro.train.step`.

The sharding rules run in this process on every LM config's full-size
parameter shapes (`jax.eval_shape`, no weights). One module fixture runs
the rest at once, as tests/test_torch_distributed.py's does: four port
ranks (tests/torch_dp_worker.py in its `zero` mode, gloo on FileStores,
one intra-op thread each, no jax) on a flat (4,) 'data' mesh and a (2, 2)
'pod' x 'data' mesh, then two of them on a (2,) mesh; and two reference
subprocesses on 4 forced host devices, side by side: its e4m3
`gather_params` on the fixtures and 3 steps of its wire step with
wire_zero_gather="fp8" on (2, 2); 3 steps of its "full" step on (4,) at
n_microbatches = 2 and of the tiny moonshot under "full" on (4,); each
with ZeRO-1 on (its default).

Models, batches and limits are tests/test_torch_distributed.py's: the
reference tests' tiny qwen2 (and the moonshot smoke config at 2 layers)
under hybrid delayed scaling, every rounding RNE, the xla backend; global
batches of 8 rows whose loss masks differ by shard; loss rel 1e-2, update
rel L2 0.35, first-step amaxes within one e5m2 notch.
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
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.distributed import sharding as jsharding
from repro.models.registry import build_config as j_build_config
from repro.models.transformer import init_lm
from repro_torch.data.pipeline import host_shard, microbatch_shard
from repro_torch.distributed import sharding
from repro_torch.models.convert import (jax_path, shard_leaves,
                                        unshard_leaves)
from test_torch_distributed import (CFG_KW, LOSS_REL, QUANT_KW,
                                    UPDATE_REL_L2, global_batches, leaves,
                                    leaves_t, rel, rel_l2)

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]
MOE_KW = dict(n_layers=2, remat=False)
RANK_TIMEOUT = 600
E4M3_MAX = 448.0
# The first step's grad norm against the reference's: the "full" path's
# microbatch rows weight each token by its global microbatch's mask count,
# which the planted contiguous-rows fault does not (readings in the test).
GNORM_REL = 2e-2
# The mixture-of-experts aux losses of the "full" step: the ranks' summed
# contributions against one process on the global batch, and against the
# reference (whose forward differs from the port's by up to 2.4e-4 rel in
# lb_loss on one process, read on the CPU).
AUX_REL = 1e-5
AUX_REF_REL = 1e-3
# dropped_frac against the reference: at most this many of the global
# batch's N_PAIRS (token, slot) pairs (8 x 32 tokens, top-2) routed or
# dropped otherwise (one read on the CPU).
DROP_PAIRS = 2
N_PAIRS = 8 * 32 * 2
# ZeRO-1 on against off at N = 4: the reduce-scatter adds in rank order,
# gloo's all-reduce in its own; the update within f32 rounding.
ZERO_N4_REL = 1e-6
LM_ARCHS = ["qwen2-1.5b", "paper-transformer", "codeqwen1.5-7b",
            "internlm2-20b", "mistral-large-123b", "moonshot-v1-16b-a3b",
            "dbrx-132b", "llava-next-34b", "seamless-m4t-large-v2",
            "recurrentgemma-9b", "xlstm-125m"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for this file (the suite runs
    in several worker processes on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the sharding rules, from shapes alone
# ---------------------------------------------------------------------------

def _mesh(sizes):
    """What the reference's rules read of a mesh: its shape and names."""
    return types.SimpleNamespace(shape=dict(sizes),
                                 axis_names=tuple(sizes))


def _np_specs(tree):
    """A PartitionSpec tree -> a tree of tuples."""
    return jax.tree_util.tree_map(
        lambda s: tuple(s), tree,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _shapes(cfg):
    """The config's full-size parameter tree as ShapeDtypeStructs."""
    return jax.eval_shape(lambda k: init_lm(k, cfg), jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_sharding_rules_are_the_reference(arch):
    """`param_specs`, `zero1_specs`, `batch_specs` and `replicated` of the
    port, on the config's full-size parameter shapes (the reference's
    tree, paths and stacked layers), equal the reference's at model sizes
    1, 2, 16 and data sizes 1, 2, 4."""
    shapes = _shapes(j_build_config(arch))
    batch = {"tokens": np.zeros((8, 128)), "labels": np.zeros((8, 128)),
             "loss_mask": np.zeros((6, 128)), "scalar": np.zeros(())}
    n_sharded = 0
    for m in (1, 2, 16):
        for d in (1, 2, 4):
            sizes = {"pod": 1, "data": d, "model": m}
            jmesh = _mesh(sizes)
            want_p = _np_specs(jsharding.param_specs(shapes, jmesh))
            got_p = sharding.param_specs(shapes, sizes)
            assert leaves_t(got_p) == leaves_t(want_p)
            want_z = _np_specs(jsharding.zero1_specs(
                shapes, jsharding.param_specs(shapes, jmesh), jmesh))
            got_z = sharding.zero1_specs(shapes, got_p, sizes)
            assert leaves_t(got_z) == leaves_t(want_z)
            n_sharded += sum("data" in s for s in leaves_t(got_z).values())
            want_b = _np_specs(jsharding.batch_specs(batch, jmesh))
            assert leaves_t(sharding.batch_specs(batch, sizes)) \
                == leaves_t(want_b)
    assert n_sharded > 0
    assert set(leaves_t(sharding.replicated(shapes)).values()) == {()}


def test_port_paths_map_to_the_reference():
    """`jax_path` maps the port's per-layer paths to the reference's
    scanned stacks and remainder layers; the rules give a port leaf the
    reference leaf's spec with the group dim dropped."""
    cfg = j_build_config("recurrentgemma-9b").replace(n_layers=8)
    assert len(cfg.pattern()) == 3 and cfg.scan_layers
    assert jax_path("decoder/layer_0/attn/wq", cfg) == \
        "decoder/stack_0/attn/wq"
    assert jax_path("decoder/layer_4/rglru/wx", cfg) == \
        "decoder/stack_1/rglru/wx"
    assert jax_path("decoder/layer_7/rglru/wx", cfg) == \
        "decoder/rem_1/rglru/wx"
    assert jax_path("embed/table", cfg) == "embed/table"
    flat = cfg.replace(scan_layers=False)
    assert jax_path("decoder/layer_7/mlp/up", flat) == "decoder/rem_1/mlp/up"
    assert jax_path("decoder/layer_2/mlp/up", flat) == \
        "decoder/layer_2/mlp/up"
    shapes = _shapes(cfg)
    sizes = {"data": 1, "model": 16}
    want = leaves_t(_np_specs(jsharding.param_specs(shapes, _mesh(sizes))))
    # The port's tree: the first group of each stack as layer_{pos}, the
    # remainder layers after the groups, every leaf at its per-layer shape.
    port, expect = {}, {}
    groups = cfg.n_layers // 3
    for path, leaf in leaves_t(shapes).items():
        parts = path.strip("/").split("/")
        shape, spec = tuple(leaf.shape), want[path]
        if len(parts) > 1 and parts[1].startswith("stack_"):
            parts[1] = f"layer_{parts[1][len('stack_'):]}"
            shape, spec = shape[1:], (spec[1:] if spec else ())
        elif len(parts) > 1 and parts[1].startswith("rem_"):
            parts[1] = f"layer_{groups * 3 + int(parts[1][len('rem_'):])}"
        node = port
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = types.SimpleNamespace(shape=shape)
        expect["/" + "/".join(parts)] = spec
    got = leaves_t(sharding.param_specs(
        port, sizes, path_of=lambda q: jax_path(q, cfg)))
    assert got == expect
    assert any("model" in s_ for s_ in got.values())


@pytest.mark.parametrize("n", [2, 4])
def test_plan_specs_are_the_reference(n):
    """The plan's `master_specs` / `grad_specs`, `train_state_specs` and
    `batch_specs` on a (n,) 'data' mesh with ZeRO-1, from the smoke
    qwen2's shapes, equal the reference plan's."""
    from repro.core.precision_policy import DistConfig as JDistConfig
    from repro.distributed import strategy as jstrategy
    from repro_torch.core.precision_policy import DistConfig
    from repro_torch.distributed import strategy
    shapes = _shapes(j_build_config("qwen2-1.5b", smoke=True))
    jplan = jstrategy.ParallelPlan(
        mesh=_mesh({"data": n}), dist=JDistConfig(),
        dp=jstrategy.DataParallel(("data",)),
        zero1=jstrategy.ZeRO1Sharded(), tp=None)
    plan = strategy.ParallelPlan(
        mesh=types.SimpleNamespace(mesh_dim_names=("data",),
                                   mesh=torch.arange(n)),
        dist=DistConfig(), dp=strategy.DataParallel(("data",)),
        zero1=strategy.ZeRO1Sharded(), tp=None)
    state = types.SimpleNamespace(master=shapes, opt_state={
        "count": np.zeros(()), "mu": shapes, "nu": shapes})
    batch = {"tokens": np.zeros((8, 16)), "labels": np.zeros((6, 16))}
    for got, want in (
            (plan.master_specs(shapes), jplan.master_specs(shapes)),
            (plan.grad_specs(shapes), jplan.grad_specs(shapes)),
            (plan.batch_specs(batch), jplan.batch_specs(batch))):
        assert leaves_t(got) == leaves_t(_np_specs(want))
    got, want = plan.train_state_specs(state), jplan.train_state_specs(state)
    for part in ("master", "opt_state"):
        assert leaves_t(getattr(got, part)) == \
            leaves_t(_np_specs(getattr(want, part)))
    assert tuple(tuple(x) for x in dataclasses.astuple(want.loss_scale)) \
        == dataclasses.astuple(got.loss_scale)
    assert any("data" in s_ for s_ in leaves_t(got.master).values())


def test_zero_layouts_round_trip():
    """`shard_leaves` / `unshard_leaves`: a whole tree -> N ranks' shards ->
    the whole tree, leaf for leaf; a leaf without a dim is whole on every
    rank."""
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(8, 6, generator=g),
            "b": {"c": torch.randn(3, 12, generator=g),
                  "d": torch.randn(5, generator=g)}}
    dims = {"a": 0, "b": {"c": 1, "d": None}}
    for n in (2, 4):
        shards = [shard_leaves(tree, dims, i, n) for i in range(n)]
        assert shards[1]["a"].shape == (8 // n, 6)
        assert shards[1]["b"]["c"].shape == (3, 12 // n)
        assert shards[1]["b"]["d"] is tree["b"]["d"]
        back = unshard_leaves(shards, dims)
        for k, v in leaves_t(back).items():
            assert torch.equal(v, leaves_t(tree)[k])


@pytest.mark.parametrize("n_hosts,n_mb", [(1, 2), (2, 2), (4, 2), (2, 4),
                                          (4, 1)])
def test_microbatch_rows_are_the_global_microbatches(n_hosts, n_mb):
    """`microbatch_shard`: the step's split of a rank's rows into n gives,
    in microbatch i, this rank's `host_shard` of the reference's
    microbatch i (global rows [i B / n, (i + 1) B / n)); one microbatch is
    `host_shard`."""
    b = {"x": np.arange(16 * 3).reshape(16, 3)}
    per = 16 // n_mb
    for r in range(n_hosts):
        rows = microbatch_shard(b, r, n_hosts, n_mb)["x"]
        mine = np.split(rows, n_mb)
        for i in range(n_mb):
            glob = {"x": b["x"][i * per:(i + 1) * per]}
            np.testing.assert_array_equal(
                mine[i], host_shard(glob, r, n_hosts)["x"])
        if n_mb == 1:
            np.testing.assert_array_equal(rows, host_shard(b, r,
                                                           n_hosts)["x"])


# ---------------------------------------------------------------------------
# the ranks and the reference subprocess
# ---------------------------------------------------------------------------

def jax_cfg(arch="qwen2-1.5b", **kw):
    from repro.core.precision_policy import QuantConfig as JQuantConfig
    cfg = j_build_config(arch, smoke=True).replace(scan_layers=False, **kw)
    return cfg.replace(policy=dataclasses.replace(
        cfg.policy, quant=JQuantConfig(**QUANT_KW)))


def gather_fixtures(n, rng):
    """Whole leaves in bf16 values (f32 arrays). 'pow2': every leaf's
    largest magnitude 448 x 2^k, so its shared scale is 2^k and every
    division exact; 'general': scales that are not powers of two. Each
    holds a leaf whose dims do not divide N (it travels whole)."""
    def bf16(x):
        return x.astype(ml_dtypes.bfloat16).astype(np.float32)

    def tree(pow2):
        out = {}
        for name, shape, k in (("w", (4 * n, 24), -3), ("v", (6, 8 * n), 2),
                               ("odd", (3, 5), 0)):
            x = bf16(rng.standard_normal(shape) * 2.0 ** k)
            if pow2:
                x = np.clip(x, -E4M3_MAX * 2.0 ** k * 0.99,
                            E4M3_MAX * 2.0 ** k * 0.99)
                x.reshape(-1)[-1] = -E4M3_MAX * 2.0 ** k
            out[name] = bf16(x)
        return out
    return {"pow2": tree(True), "general": tree(False)}


REF_SCRIPT = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core.precision_policy import DistConfig
from repro.distributed.strategy import ParallelPlan
from repro.launch.mesh import enter_mesh, make_mesh
from repro.scaling import DelayedScaling, discover_lm_sites
from repro.train.step import make_optimizer_for, make_train_step

with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
parts = sys.argv[3].split(",")
meshes = {"4": make_mesh((4,), ("data",)),
          "2x2": make_mesh((2, 2), ("pod", "data"))}
gather = {}
for n, mname in ((4, "4"), (2, "2x2")) if "gather" in parts else ():
    mesh = meshes[mname]
    plan = ParallelPlan.build(mesh, DistConfig(
        wire="fp8_ef", wire_zero_gather="fp8", tp=False))
    gather[n] = {}
    for name, fix in inp["gather"][n].items():
        tree = {k: jnp.asarray(v, jnp.bfloat16) for k, v in fix.items()}
        with enter_mesh(mesh):
            out = jax.jit(plan.gather_params)(tree)
        gather[n][name] = {k: np.asarray(v.astype(jnp.float32))
                           for k, v in out.items()}
runs = {}
for run, mname, wire, zg, n_mb, key in (
        ("mb2", "4", "full", "full", 2, "qwen"),
        ("moe", "4", "full", "full", 1, "moe"),
        ("grid_fp8_gather", "2x2", "fp8_ef", "fp8", 1, "qwen")):
    if run not in parts:
        continue
    cfg = inp["jcfg_" + key]
    params = jax.tree_util.tree_map(jnp.asarray, inp["params_" + key])
    mesh = meshes[mname]
    plan = ParallelPlan.build(mesh, DistConfig(wire=wire,
                                               wire_zero_gather=zg,
                                               tp=False))
    reg = discover_lm_sites(cfg, params, {
        k: jnp.asarray(v) for k, v in inp["probe_" + key].items()})
    ds = DelayedScaling(reg, qcfg=cfg.policy.quant)
    opt = make_optimizer_for(cfg, learning_rate=1e-3)
    step = jax.jit(make_train_step(cfg, opt, scaling=ds, plan=plan,
                                   n_microbatches=n_mb))
    state, ss = opt.init(params), ds.init()
    err = plan.init_wire_state(state.master) if plan.compresses else None
    mets = []
    with enter_mesh(mesh):
        for i, b in enumerate(inp["batches_" + key]):
            k = jax.random.fold_in(jax.random.PRNGKey(7), i)
            b = {kk: jnp.asarray(v) for kk, v in b.items()}
            if err is None:
                (state, ss), m = step(state, ss, b, k)
            else:
                (state, ss, err), m = step(state, ss, err, b, k)
            mets.append({kk: float(m[kk]) for kk in
                         ("loss", "grad_norm", "loss_scale", "lb_loss",
                          "router_z_loss", "dropped_frac") if kk in m})
    runs[run] = dict(metrics=mets,
                     master=jax.tree_util.tree_map(np.asarray, state.master),
                     amax_history=np.asarray(ss.amax_history),
                     keys=list(reg.keys))
with open(sys.argv[2], "wb") as f:
    pickle.dump({"gather": gather, "runs": runs}, f)
"""


@pytest.fixture(scope="module")
def zr(tmp_path_factory):
    """Runs the four ranks and the reference subprocess; returns their
    results."""
    import repro_torch
    work = tmp_path_factory.mktemp("zero")
    jq, jm = jax_cfg(**CFG_KW), jax_cfg("moonshot-v1-16b-a3b", **MOE_KW)
    params = {
        "qwen": jax.tree_util.tree_map(np.asarray,
                                       init_lm(jax.random.PRNGKey(0), jq)),
        "moe": jax.tree_util.tree_map(np.asarray,
                                      init_lm(jax.random.PRNGKey(1), jm))}
    batches = {"qwen": global_batches()}
    batches["moe"] = [dict(b, tokens=b["tokens"] % jm.vocab_size,
                           labels=b["labels"] % jm.vocab_size)
                      for b in batches["qwen"]]
    rng = np.random.default_rng(5)
    inp = dict(cfg_kw=CFG_KW, moe_kw=MOE_KW, quant_kw=QUANT_KW,
               gather={n: gather_fixtures(n, rng) for n in (4, 2)})
    for key in ("qwen", "moe"):
        inp["params_" + key] = params[key]
        inp["batches_" + key] = batches[key]
        inp["probe_" + key] = {k: v[:1] for k, v in batches[key][0].items()}
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    with open(work / "ref_in.pkl", "wb") as f:
        pickle.dump(dict(inp, jcfg_qwen=jq, jcfg_moe=jm), f)
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_allow_excess_precision=false")
    # Two reference subprocesses side by side (each compiles its steps).
    refs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_SCRIPT),
         str(work / "ref_in.pkl"), str(work / f"ref_out{i}.pkl"), parts],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for i, parts in enumerate(("gather,grid_fp8_gather", "mb2,moe"))]
    wenv = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen(
        [sys.executable, str(Path(__file__).with_name("torch_dp_worker.py")),
         str(r), str(work), "zero"], env=wenv, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    logs = []
    try:
        for p in ranks:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
        ref_errs = [ref.communicate(timeout=RANK_TIMEOUT)[1] for ref in refs]
    finally:
        for p in ranks + refs:
            if p.poll() is None:
                p.kill()
    for ref, err in zip(refs, ref_errs):
        assert ref.returncode == 0, err[-3000:]
    out = []
    for r in range(4):
        path = work / f"rank{r}.pkl"
        assert path.exists(), logs[r][-3000:]
        with open(path, "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, f"rank {r}:\n{res.get('error')}"
        out.append(res)
    ref_res = {"gather": {}, "runs": {}}
    for i in range(2):
        with open(work / f"ref_out{i}.pkl", "rb") as f:
            part = pickle.load(f)
        for k in ref_res:
            ref_res[k].update(part[k])
    return dict(ranks=out, ref=ref_res, inp=inp, jcfg={"qwen": jq,
                                                       "moe": jm})


def port_tree(zr, key, tree):
    """The reference's tree (numpy) -> {path: f32 array} in the port's
    layout."""
    from repro_torch.core.precision_policy import QuantConfig
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.registry import build_config
    arch, kw = (("qwen2-1.5b", CFG_KW) if key == "qwen"
                else ("moonshot-v1-16b-a3b", MOE_KW))
    cfg = build_config(arch, smoke=True, **kw)
    cfg = cfg.replace(policy=dataclasses.replace(
        cfg.policy, quant=QuantConfig(**QUANT_KW)))
    t = from_jax_params(jax.tree_util.tree_map(np.asarray, tree), cfg,
                        device="cpu")
    return {k: v.float().numpy() for k, v in leaves_t(t).items()}


def update_rel(zr, key, got_master, want_master):
    """rel L2 of the port's master-weight update against the
    reference's, from the same initial weights."""
    p0 = port_tree(zr, key, zr["inp"]["params_" + key])
    want = port_tree(zr, key, want_master)
    got = leaves(got_master)
    ks = sorted(got)
    return rel_l2([got[k].astype(np.float32) - p0[k] for k in ks],
                  [want[k] - p0[k] for k in ks])


def first_amax_ratio(got, ref):
    a, b = got["amax_history"][:, 2], ref["amax_history"][:, 2]
    assert got["keys"] == ref["keys"]
    assert ((a > 0) == (b > 0)).all()
    return a[a > 0] / b[a > 0]


def test_ranks_import_no_jax(zr):
    assert not any(r["jax_loaded"] for r in zr["ranks"])


def _codes(v, scale):
    return (v.astype(np.float64) / scale).astype(
        ml_dtypes.float8_e4m3fn).view(np.uint8)


@pytest.mark.parametrize("n", [4, 2])
def test_e4m3_gather_bitwise_on_power_of_two_scales(zr, n):
    """The port's e4m3 gather (`ParallelPlan.gather_params(fp8=True)`) on
    leaves whose shared scales are powers of two is the reference's
    `gather_params` bit for bit, on every rank; the leaf that does not
    divide N travels whole and unchanged; the zero_gather bytes a rank
    sends are the sharded leaves' numel x (N - 1) / N at one byte."""
    fix = zr["inp"]["gather"][n]["pow2"]
    want = zr["ref"]["gather"][n]["pow2"]
    sharded = 0
    for r in zr["ranks"]:
        got = r["gather"][n]["pow2"]
        for k in fix:
            np.testing.assert_array_equal(got["got"][k], want[k])
        assert got["dims"]["odd"] is None
        np.testing.assert_array_equal(got["got"]["odd"], fix["odd"])
        sharded = sum(fix[k].size for k in fix if got["dims"][k] is not None)
        assert got["bytes"] == sharded * (n - 1) / n
    assert sharded > 0
    # Quantized: the values left the bf16 input.
    assert not np.array_equal(want["w"], fix["w"])


@pytest.mark.parametrize("n", [4, 2])
def test_e4m3_gather_fault_is_seen(zr, n):
    """A planted fault, each rank quantizing its shard and decoding every
    payload with its own shard's scale instead of the MAX over the
    ranks: on the power-of-two fixtures, whose shards' amaxes differ, the
    gathered weights leave the reference's on some rank."""
    want = zr["ref"]["gather"][n]["pow2"]
    moved = [any(not np.array_equal(r["gather"][n]["pow2_fault"][k], want[k])
                 for k in want) for r in zr["ranks"]]
    assert any(moved), moved


@pytest.mark.parametrize("n", [4, 2])
def test_e4m3_gather_flip_rate_on_general_inputs(zr, n):
    """Shared scales that are not powers of two: the reference's XLA may
    divide by a scale as a multiply by its reciprocal, so a payload may
    flip to its grid neighbour: at most 1e-2 of the elements flip, to
    neighbours only."""
    fix = zr["inp"]["gather"][n]["general"]
    want = zr["ref"]["gather"][n]["general"]
    got = zr["ranks"][0]["gather"][n]["general"]["got"]
    for k in fix:
        scale = max(float(np.abs(fix[k]).max()) / E4M3_MAX, 1e-30)
        a, b = _codes(got[k], scale), _codes(want[k], scale)
        rate = float(np.mean(a != b))
        diff = a != b
        mag = np.abs((a & 0x7F).astype(int) - (b & 0x7F).astype(int))
        print(f"N={n} {k}: payload flips {rate}")
        assert rate <= 1e-2
        assert (((a >> 7) == (b >> 7)) & (mag <= 1))[diff].all()


def _grad_norm_rel(got, ref):
    return rel(got["metrics"][0]["grad_norm"], ref["metrics"][0]["grad_norm"])


def test_full_microbatch_rows_are_the_reference(zr):
    """The reference's "full" step on (4,) at n_microbatches = 2 with the
    uneven masks: its microbatch i is the global rows [i B / 2, (i + 1) B
    / 2), divided by that microbatch's global mask count (112 and 32
    tokens). The port on the loop's rows (`microbatch_shard`) holds the
    step limits, the first step's amaxes within one notch and its grad
    norm within GNORM_REL; the planted fault, each rank's contiguous rows
    split locally (72 and 72 tokens), leaves GNORM_REL."""
    ref = zr["ref"]["runs"]["mb2"]
    for r in zr["ranks"]:
        got = r["runs4"]["mb2"]
        for a, b in zip(got["metrics"], ref["metrics"]):
            assert rel(a["loss"], b["loss"]) <= LOSS_REL, (a, b)
            assert a["loss_scale"] == b["loss_scale"]
        ratio = first_amax_ratio(got, ref)
        assert ((ratio <= 1.25) & (ratio >= 0.8)).all()
        e = update_rel(zr, "qwen", got["master"], ref["master"])
        g = _grad_norm_rel(got, ref)
        print(f"mb2 rank {got['dp_rank']}: update rel L2 {e:.4f}, first "
              f"grad norm rel {g:.3e}")
        assert e <= UPDATE_REL_L2 and g <= GNORM_REL
    bad = zr["ranks"][0]["runs4"]["mb2_contiguous"]
    g = _grad_norm_rel(bad, ref)
    e = update_rel(zr, "qwen", bad["master"], ref["master"])
    print(f"contiguous-rows fault: first grad norm rel {g:.3e}, update rel "
          f"L2 {e:.4f}")
    assert g > GNORM_REL


def test_moe_full_aux_losses_are_the_reference(zr):
    """The tiny moonshot (per-sample dispatch) under "full" on (4,): the
    first step's lb_loss, router_z_loss and dropped_frac (the ranks'
    contributions summed) within AUX_REL of the port's one-process step on
    the whole global batch (the same arithmetic the reference's one
    program does), and within AUX_REF_REL (dropped_frac: DROP_PAIRS
    pairs) of the reference's global values from the same weights (its
    forward and the port's differ by up to 2.4e-4 in lb_loss on one
    process already, and one pair's drop); every step's loss
    within LOSS_REL and the update within UPDATE_REL_L2 (the later steps'
    weights differ by the fp8 roundings, so their aux losses are
    printed); the replicas equal."""
    ref = zr["ref"]["runs"]["moe"]
    runs = [r["runs4"]["moe"] for r in zr["ranks"]]
    got = runs[0]
    m0, j0, s0 = got["metrics"][0], ref["metrics"][0], \
        zr["ranks"][0]["moe_solo"]
    for k in ("lb_loss", "router_z_loss", "dropped_frac"):
        print(f"moe step 0 {k}: 4 ranks {m0[k]!r}, one process {s0[k]!r}, "
              f"reference {j0[k]!r}")
        assert rel(m0[k], s0[k]) <= AUX_REL, (k, m0[k], s0[k])
        if k == "dropped_frac":
            # One pair's route or drop may differ (forward noise).
            assert abs(m0[k] - j0[k]) <= DROP_PAIRS / N_PAIRS, (m0[k], j0[k])
        else:
            assert rel(m0[k], j0[k]) <= AUX_REF_REL, (k, m0[k], j0[k])
    for a, b in zip(got["metrics"], ref["metrics"]):
        print(f"moe: loss {a['loss']:.6f} vs {b['loss']:.6f}, lb "
              f"{a['lb_loss']:.6g} vs {b['lb_loss']:.6g}, z "
              f"{a['router_z_loss']:.6g} vs {b['router_z_loss']:.6g}, "
              f"dropped {a['dropped_frac']:.6g} vs {b['dropped_frac']:.6g}")
        assert rel(a["loss"], b["loss"]) <= LOSS_REL
    e = update_rel(zr, "moe", got["master"], ref["master"])
    print(f"moe: update rel L2 {e:.4f}")
    assert e <= UPDATE_REL_L2
    for other in runs[1:]:
        for k, v in leaves(got["master"]).items():
            np.testing.assert_array_equal(v, leaves(other["master"])[k])


def _same_state(a, b):
    for part in ("master", "mu", "nu", "loss_scale"):
        x, y = leaves(a[part]), leaves(b[part])
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"{part} {k}")
    np.testing.assert_array_equal(a["amax_history"], b["amax_history"])
    np.testing.assert_array_equal(a["scale"], b["scale"])


@pytest.mark.parametrize("wire", ["full", "fp8_ef"])
def test_zero_on_is_zero_off_bitwise_at_two_ranks(zr, wire):
    """At N = 2 f32 a + b does not depend on the order: ZeRO-1 on (state
    gathered whole) equals ZeRO-1 off, master weights, moments, loss
    scale and ScaleState bit for bit, with the bf16 gather; each step's
    loss too."""
    for r in zr["ranks"][:2]:
        on, off = r["runs2"][f"{wire}/True"], r["runs2"][f"{wire}/False"]
        _same_state(on, off)
        assert [m["loss"] for m in on["metrics"]] \
            == [m["loss"] for m in off["metrics"]]
        assert on["dims"] is not None and off["dims"] is None


@pytest.mark.parametrize("wire", ["full", "fp8_ef"])
def test_zero_on_is_zero_off_within_rounding_at_four_ranks(zr, wire):
    """At N = 4 gloo's all-reduce and the rank-order reduce-scatter may add
    in different orders: the update with ZeRO-1 on against off within
    ZERO_N4_REL (rel L2), the loss scale equal (readings printed)."""
    p0 = port_tree(zr, "qwen", zr["inp"]["params_qwen"])
    for r in zr["ranks"]:
        on, off = r["runs4"][f"{wire}/True"], r["runs4"][f"{wire}/False"]
        a, b = leaves(on["master"]), leaves(off["master"])
        ks = sorted(a)
        e = rel_l2([a[k].astype(np.float32) - p0[k] for k in ks],
                   [b[k].astype(np.float32) - p0[k] for k in ks])
        print(f"N=4 {wire} rank {r['runs4'][f'{wire}/True']['dp_rank']}: "
              f"ZeRO on vs off update rel L2 {e:.3e}")
        assert e <= ZERO_N4_REL
        for k, x in leaves(on["loss_scale"]).items():
            np.testing.assert_array_equal(x, leaves(off["loss_scale"])[k])


def test_fp8_gather_is_inert_under_full(zr):
    """The reference calls its fp8 gather from its wire steps alone: under
    "full", wire_zero_gather="fp8" trains as "full" does, bit for bit."""
    for r in zr["ranks"]:
        _same_state(r["runs4"]["full/True/fp8"], r["runs4"]["full/True"])


def test_wire_fp8_gather_against_the_reference(zr):
    """The reference's wire step with wire_zero_gather="fp8" on (2, 2)
    (ZeRO-1 over 'data', the e5m2 wire over 'pod') against the port's:
    losses, loss scales, first-step amaxes and the update within the step
    limits; the fp8 gather moved the weights (the run differs from the
    bf16 gather's)."""
    ref = zr["ref"]["runs"]["grid_fp8_gather"]
    for r in zr["ranks"]:
        got = r["runs4"]["grid_fp8_gather"]
        for a, b in zip(got["metrics"], ref["metrics"]):
            assert rel(a["loss"], b["loss"]) <= LOSS_REL, (a, b)
            assert a["loss_scale"] == b["loss_scale"]
        ratio = first_amax_ratio(got, ref)
        assert ((ratio <= 1.25) & (ratio >= 0.8)).all()
        e = update_rel(zr, "qwen", got["master"], ref["master"])
        print(f"fp8 gather rank {got['dp_rank']}: update rel L2 {e:.4f}")
        assert e <= UPDATE_REL_L2
    got = zr["ranks"][0]["runs4"]["grid_fp8_gather"]
    assert got["metrics"][0]["loss"] != \
        zr["ranks"][0]["runs4"]["fp8_ef/True"]["metrics"][0]["loss"] or \
        got["metrics"][0]["grad_norm"] != \
        zr["ranks"][0]["runs4"]["fp8_ef/True"]["metrics"][0]["grad_norm"]


@pytest.mark.parametrize("run", ["full/True", "fp8_ef/True",
                                 "grid_fp8_gather"])
def test_zero_replicas_bit_identical(zr, run):
    """After 3 steps the gathered master weights, moments, loss scale and
    ScaleState are equal on every rank, bit for bit, and each rank's
    shards are exactly its slice of that state."""
    runs = [r["runs4"][run] for r in zr["ranks"]]
    for other in runs[1:]:
        _same_state(runs[0], other)
    for got in runs:
        whole = {k: torch.from_numpy(v) for k, v in
                 leaves(got["master"]).items()}
        dims = leaves_t(got["dims"])
        n = 4 if run != "grid_fp8_gather" else 2
        for k, shard in leaves(got["shard"]).items():
            want = whole[k] if dims[k] is None else torch.chunk(
                whole[k], n, dim=dims[k])[got["zero_rank"]]
            np.testing.assert_array_equal(shard, want.numpy())
    assert any(d is not None for d in leaves_t(runs[0]["dims"]).values())


@pytest.mark.parametrize("run", ["full/True", "grid_fp8_gather"])
def test_shard_digests_are_the_whole_states(zr, run):
    """The launcher report's `state_digest` of a ZeRO-1 state, computed
    from each rank's shards (their checksums summed over 'data' at the
    words' positions in the whole leaves), equals the digest of the state
    gathered whole, on every rank."""
    digests = [r["runs4"][run]["digests"] for r in zr["ranks"]]
    for sharded, whole in digests:
        assert sharded == whole
    assert len({d for pair in digests for d in pair}) == 1


def test_an_overflow_in_one_shard_skips_the_step_everywhere(zr):
    """An inf planted in rank 1's shard after the reduce-scatter: the
    overflow flag is combined over 'data' before the update, so every
    rank skips the step (master weights and moments unchanged, the loss
    scale halved) and the replicas stay equal."""
    p0 = port_tree(zr, "qwen", zr["inp"]["params_qwen"])
    runs = [r["runs4"]["overflow"] for r in zr["ranks"]]
    for got in runs:
        m = got["metrics"][0]
        assert m["grads_finite"] is False
        assert m["loss_scale"] == 4096.0
        for k, v in leaves(got["master"]).items():
            np.testing.assert_array_equal(
                v, p0[k].astype(np.float16).astype(np.float32))
        assert all(float(np.abs(v).max()) == 0
                   for v in leaves(got["mu"]).values())
    for other in runs[1:]:
        _same_state(runs[0], other)


def test_zero_loop_resumes_and_restores_elastically(zr):
    """The launcher's TrainLoop on two ranks, fp8 wire, ZeRO-1 on: 4 steps
    against 2 + a restore + 2, bit for bit (master weights, moments, loss
    scale, ScaleState, each rank's residual); a checkpoint written with
    ZeRO-1 off restores under ZeRO-1 on, and the other way round, to the
    same state. The checkpoint holds whole arrays (the reference's
    layout)."""
    for r in zr["ranks"][:2]:
        loops = r["loops"]
        base = loops["on"]
        for name in ("on_resumed", "off_then_on", "on_then_off"):
            other = loops[name]
            assert other["last_step"] == 4
            for part in ("master", "opt", "err", "loss_scale"):
                a, b = leaves(base[part]), leaves(other[part])
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k],
                                                  err_msg=f"{name} {part}")
            for x, y in zip(base["ss"], other["ss"]):
                np.testing.assert_array_equal(x, y)
    shapes = zr["ranks"][0]["ckpt_shapes"]
    whole = {k: v.shape for k, v in
             leaves(zr["ranks"][0]["loops"]["on"]["master"]).items()}
    table = [s for k, s in shapes.items() if "embed__table" in k
             and "master" in k]
    assert table == [whole["/embed/table"]], (table, whole["/embed/table"])
