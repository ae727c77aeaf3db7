"""One rank of tests/test_torch_distributed.py's gloo process group.

    python tests/torch_dp_worker.py RANK WORKDIR [zero | tp]

Reads WORKDIR/inputs.pkl (the reference's initial weights, the batches,
the reduction fixtures; numpy only), runs every multi-rank case of the
port on one intra-op thread, and writes WORKDIR/rank<RANK>.pkl. It imports
torch and repro_torch, never jax: the file records whether jax was loaded.

Three process groups, one after the other, all on FileStores in WORKDIR:
 1. a group of one (this rank alone): the plan on a (1,) mesh;
 2. the four ranks: the plans on a flat (4,) 'data' mesh and a (2, 2)
    'pod' x 'data' mesh, the compressed reductions, the error-feedback
    law, the training steps on both wires, amax_sync, the refusals;
 3. ranks 0 and 1: the TrainLoop's interrupted-and-resumed run.

With `zero` it runs tests/test_torch_zero.py's cases instead (`zero_main`):
the e4m3 gather, the "full" path's microbatch rows and mixture-of-experts
aux losses, ZeRO-1 on against off on four ranks, then on two, the
TrainLoop's resume and elastic restores under ZeRO-1. With `tp`,
tests/test_torch_tp.py's (`tp_main`): tensor parallelism on (1, 4) and
(2, 2) meshes of the four ranks, then on (1, 2) on ranks 0 and 1 while
ranks 2 and 3 run the one-process steps they are held against.
"""
import datetime
import os
import pickle
import sys
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

WORLD = 4
TIMEOUT = datetime.timedelta(seconds=300)


def npt(tree):
    """A tree of tensors -> a tree of numpy arrays (bf16 / fp8 as f32)."""
    if isinstance(tree, dict):
        return {k: npt(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float8_e5m2,
                       torch.float8_e4m3fn):
            t = t.float()
        return t.numpy().copy()
    return tree


def join(path, rank, world):
    dist.init_process_group("gloo", store=dist.FileStore(path, world),
                            rank=rank, world_size=world, timeout=TIMEOUT)


def tiny_cfg(inp):
    """The reference tests' tiny qwen2 (inputs' `cfg_kw`), hybrid delayed
    scaling on the xla backend, every rounding RNE."""
    import dataclasses

    from repro_torch.core.precision_policy import QuantConfig
    from repro_torch.models.registry import build_config
    cfg = build_config("qwen2-1.5b", smoke=True, **inp["cfg_kw"])
    quant = QuantConfig(**inp["quant_kw"])
    return cfg.replace(policy=dataclasses.replace(cfg.policy, quant=quant))


DISTS = {
    "default": {},
    "fp8": {"wire": "fp8_ef"},
    "fp8_dp_only": {"wire": "fp8_ef", "zero1": False, "tp": False},
    "wire_axis_data": {"wire": "fp8_ef", "wire_axis": "data"},
    "wire_axis_pod": {"wire": "fp8_ef", "wire_axis": "pod"},
    "dp_off": {"dp": False, "zero1": False, "tp": False},
}


def plan_table(mesh, params):
    """Each DISTS entry's plan on `mesh`: its bookkeeping and wire bytes,
    or the error build raised."""
    from repro_torch.core.precision_policy import DistConfig
    from repro_torch.distributed.strategy import ParallelPlan
    out = {}
    for name, kw in DISTS.items():
        try:
            plan = ParallelPlan.build(mesh, DistConfig(**kw))
        except (ValueError, NotImplementedError) as e:
            out[name] = ("error", type(e).__name__, str(e))
            continue
        out[name] = dict(describe=plan.describe(), wire_axis=plan.wire_axis,
                         inner_dp_axes=plan.inner_dp_axes,
                         n_wire=plan.n_wire, compresses=plan.compresses,
                         wire_bytes=plan.wire_bytes(params))
    return out


def solo(rank, workdir, inp, out):
    """This rank alone: the (1,) mesh's plans, the inert fp8 wire, and
    host_amax_sync on one process."""
    from repro_torch.distributed import host_amax_sync
    from repro_torch.models.convert import from_jax_params
    join(os.path.join(workdir, f"solo{rank}"), 0, 1)
    params = from_jax_params(inp["params"], tiny_cfg(inp), device="cpu")
    mesh = DeviceMesh("cpu", torch.tensor([0]), mesh_dim_names=("data",))
    out["plans"] = {"1": plan_table(mesh, params)}
    vec = np.array([1.0, 2.5, 0.0], np.float32)
    out["host_amax_sync_solo"] = host_amax_sync(vec) is vec
    dist.destroy_process_group()


def reductions(rank, grid, flat, inp, out):
    """The compressed reductions at N = 4 (flat) and N = 2 (the grid's
    'pod' groups, each taking the slot of its pod coordinate); the
    error-feedback law's runs; the counted payload bytes."""
    from repro_torch.distributed import comm
    from repro_torch.distributed.grad_compress import compressed_psum_mean
    pod = dict(zip(grid.mesh_dim_names, grid.get_coordinate()))["pod"]
    res = {}
    for n, group, slot in ((4, flat.get_group("data"), rank),
                           (2, grid.get_group("pod"), pod)):
        fix = inp["compress"][n]
        tree = {k: torch.from_numpy(v[slot].copy()) for k, v in fix.items()}
        comm.reset_counts()
        red, err = compressed_psum_mean(tree, None, group=group)
        sent = comm.counts()["sent_bytes"].get("payload", 0)
        # A second step from the first's residual.
        red2, err2 = compressed_psum_mean(tree, err, group=group)
        res[n] = dict(red=npt(red), err=npt(err), red2=npt(red2),
                      err2=npt(err2), payload_bytes=sent)
    out["compress"] = res
    ef = []
    for g in inp["ef"]:
        x = {"g": torch.from_numpy(g[rank].copy())}
        grp = flat.get_group("data")
        red1, _ = compressed_psum_mean(x, None, group=grp)
        acc = torch.zeros_like(x["g"])
        err = None
        for _ in range(16):
            red, err = compressed_psum_mean(x, err, group=grp)
            acc = acc + red["g"]
        ef.append((red1["g"].numpy().copy(), acc.numpy().copy()))
    out["ef"] = ef


def localmean_lm_loss(orig, n_ranks):
    """The planted fault of the "full" path: each rank's nll divided by
    its own mask count times N, so the ranks' sum is the mean of local
    means (the wire path's normalization), not the global mean."""
    def lm_loss(params, batch, *, loss_denom=None, **kw):
        mask = torch.as_tensor(batch["loss_mask"], dtype=torch.float32)
        local = torch.clamp_min(mask.sum(), 1.0) * n_ranks
        return orig(params, batch, loss_denom=local, **kw)
    return lm_loss


def train_run(rank, mesh, wire, inp, fault=False):
    """Three steps of the port's step under a plan on `mesh`, on this
    rank's shard of the inputs' global batches. Returns per-step metrics,
    the final state and ScaleState, and the residual (wire)."""
    from repro_torch.core.precision_policy import DistConfig
    from repro_torch.data.pipeline import host_shard
    from repro_torch.distributed.strategy import ParallelPlan
    from repro_torch.models.convert import from_jax_params
    from repro_torch.scaling.calibrate import discover_lm_sites
    from repro_torch.scaling.state import DelayedScaling
    from repro_torch.train import step as step_mod
    cfg = tiny_cfg(inp)
    plan = ParallelPlan.build(mesh, DistConfig(wire=wire, zero1=False,
                                               tp=False))
    params = from_jax_params(inp["params"], cfg, device="cpu")
    reg = discover_lm_sites(cfg, params, inp["probe"])
    ds = DelayedScaling(reg, qcfg=cfg.policy.quant)
    opt = step_mod.make_optimizer_for(cfg, learning_rate=1e-3)
    state, ss = opt.init(params), ds.init()
    err = plan.init_wire_state(state.master) if plan.compresses else None
    orig = step_mod.lm_loss
    if fault:
        step_mod.lm_loss = localmean_lm_loss(orig, plan.dp_size)
    try:
        step = step_mod.make_train_step(cfg, opt, scaling=ds, plan=plan,
                                        device="cpu")
        mets, err0 = [], None
        for i, b in enumerate(inp["batches"]):
            local = host_shard(b, plan.dp_rank, plan.dp_size)
            gen = torch.Generator().manual_seed(i)
            if err is None:
                (state, ss), m = step(state, ss, local, gen)
            else:
                (state, ss, err), m = step(state, ss, err, local, gen)
                if i == 0:
                    err0 = npt(err)
            mets.append({k: v for k, v in m.items()
                         if not k.startswith("health/")})
    finally:
        step_mod.lm_loss = orig
    return dict(metrics=mets, master=npt(state.master),
                opt=npt({k: v for k, v in state.opt_state.items()}),
                loss_scale={f: npt(getattr(state.loss_scale, f))
                            for f in ("scale", "growth_count", "step",
                                      "overflow_count")},
                amax_history=ss.amax_history.copy(), scale=ss.scale.copy(),
                keys=list(reg.keys), err=npt(err) if err is not None
                else None, err0=err0, dp_rank=plan.dp_rank)


def amax_sync_runs(rank, flat, inp):
    """One step without a plan, each rank on its own shard of batch 0,
    with and without the amax_sync hook: the ScaleStates after it."""
    from repro_torch.data.pipeline import host_shard
    from repro_torch.distributed import make_amax_sync
    from repro_torch.models.convert import from_jax_params
    from repro_torch.scaling.calibrate import discover_lm_sites
    from repro_torch.scaling.state import DelayedScaling
    from repro_torch.train.step import make_optimizer_for, make_train_step
    cfg = tiny_cfg(inp)
    local = host_shard(inp["batches"][0], rank, WORLD)
    out = {}
    for name, hook in (("synced", make_amax_sync(flat.get_group("data"))),
                       ("plain", None)):
        params = from_jax_params(inp["params"], cfg, device="cpu")
        reg = discover_lm_sites(cfg, params, inp["probe"])
        ds = DelayedScaling(reg, qcfg=cfg.policy.quant)
        opt = make_optimizer_for(cfg, learning_rate=1e-3)
        step = make_train_step(cfg, opt, scaling=ds, amax_sync=hook,
                               device="cpu")
        (_, ss), _ = step(opt.init(params), ds.init(), local,
                          torch.Generator().manual_seed(0))
        out[name] = (ss.amax_history.copy(), ss.scale.copy())
    return out


def refusals(flat, inp):
    """The messages of what the step and the loop refuse."""
    import dataclasses

    from repro_torch.core.precision_policy import DistConfig
    from repro_torch.distributed.strategy import ParallelPlan
    from repro_torch.models.registry import build_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.step import make_optimizer_for, make_train_step
    cfg = tiny_cfg(inp)
    opt = make_optimizer_for(cfg)
    tp_mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2),
                         mesh_dim_names=("data", "model"))
    # Tensor parallelism runs delayed scaling on the fused path.
    fused = cfg.replace(policy=dataclasses.replace(
        cfg.policy, quant=dataclasses.replace(cfg.policy.quant,
                                              backend="pallas")))
    tp_plan = ParallelPlan.build(tp_mesh, DistConfig(zero1=False))
    cases = {
        "zero1": (cfg, ParallelPlan.build(flat, DistConfig())),
        "tp": (fused, tp_plan),
        "fp8_gather": (cfg, ParallelPlan.build(flat, DistConfig(
            zero1=False, tp=False, wire_zero_gather="fp8"))),
    }
    moe = build_config("moonshot-v1-16b-a3b", smoke=True).replace(
        n_layers=2, remat=False)
    moe = moe.replace(policy=dataclasses.replace(
        moe.policy, quant=dataclasses.replace(moe.policy.quant,
                                              backend="xla")))
    cases["moe_full"] = (moe, ParallelPlan.build(flat, DistConfig(
        zero1=False, tp=False)))
    cases["moe_global_dispatch_full"] = (
        moe.replace(moe_per_sample_dispatch=False),
        ParallelPlan.build(flat, DistConfig(zero1=False, tp=False)))
    cases["tp_moe"] = (moe, tp_plan)
    out = {}
    for name, (c, plan) in cases.items():
        try:
            make_train_step(c, make_optimizer_for(c), plan=plan,
                            device="cpu")
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    # One step of the dense decoder under the TP plan, on this rank's
    # rows of the 'data' dim.
    from repro_torch.data.pipeline import host_shard
    topt = make_optimizer_for(fused)
    state = tp_plan.shard_state(topt.init(init_lm(fused, seed=0,
                                                  device="cpu")))
    _, m = make_train_step(fused, topt, plan=tp_plan, device="cpu")(
        state, host_shard(inp["batches"][0], tp_plan.dp_rank,
                          tp_plan.dp_size), torch.Generator().manual_seed(0))
    out["tp_step_loss"] = m["loss"]
    try:
        TrainLoop(cfg, opt, iter(()), LoopConfig(
            checkpoint_dir=tempfile.mkdtemp()), plan=cases["zero1"][1],
            device="cpu")
        out["loop_zero1"] = None
    except NotImplementedError as e:
        out["loop_zero1"] = str(e)
    try:
        ParallelPlan.build(tp_mesh, DistConfig(wire="fp8_ef"))
        out["fp8_tp_build"] = None
    except NotImplementedError as e:
        out["fp8_tp_build"] = str(e)
    # Under fp8_ef the reference's step is per rank, so MoE runs: one
    # step on this rank's 2 rows.
    plan = ParallelPlan.build(flat, DistConfig(wire="fp8_ef", zero1=False,
                                               tp=False))
    mopt = make_optimizer_for(moe)
    state = mopt.init(init_lm(moe, seed=0, device="cpu"))
    step = make_train_step(moe, mopt, plan=plan, device="cpu")
    b = {k: v[2 * dist.get_rank():2 * dist.get_rank() + 2]
         for k, v in inp["batches"][0].items()}
    b["tokens"] = b["tokens"] % moe.vocab_size
    b["labels"] = b["labels"] % moe.vocab_size
    (state, _), m = step(state, plan.init_wire_state(state.master), b,
                         torch.Generator().manual_seed(0))
    out["moe_fp8_ef_loss"] = m["loss"]
    out["moe_fp8_ef_master"] = npt(state.master)
    return out


def group(rank, workdir, inp, out):
    from repro_torch.models.convert import from_jax_params
    join(os.path.join(workdir, "group"), rank, WORLD)
    flat = DeviceMesh("cpu", torch.arange(WORLD), mesh_dim_names=("data",))
    grid = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2),
                      mesh_dim_names=("pod", "data"))
    params = from_jax_params(inp["params"], tiny_cfg(inp), device="cpu")
    out["plans"]["4"] = plan_table(flat, params)
    out["plans"]["2x2"] = plan_table(grid, params)
    reductions(rank, grid, flat, inp, out)
    out["train"] = {"wire": train_run(rank, grid, "fp8_ef", inp),
                    "full": train_run(rank, flat, "full", inp),
                    "full_localmean": train_run(rank, flat, "full", inp,
                                                fault=True)}
    out["amax_sync"] = amax_sync_runs(rank, flat, inp)
    out["refusals"] = refusals(flat, inp)
    dist.destroy_process_group()


def pair(rank, workdir, inp, out):
    """Ranks 0 and 1: the launcher's TrainLoop on the fp8 wire, 4 steps in
    one run against 2 + a restore + 2, and a resumed run that skips the
    residual's restore (a planted fault)."""
    from repro_torch.launch.train import build_loop, build_plan
    from repro_torch.optim.optimizers import tmap
    join(os.path.join(workdir, "pair"), rank, 2)
    plan = build_plan(2, "gloo", "cpu", wire="fp8_ef")
    root = os.path.join(workdir, "loops")

    def run(name, total, skip_err=False):
        loop = build_loop(arch="qwen2-1.5b", smoke=True, n_layers=2,
                          steps=total, batch=4, seq=32, recipe="hybrid",
                          ckpt_dir=os.path.join(root, name),
                          checkpoint_every=2, log_every=2, plan=plan,
                          device="cpu")
        if skip_err:
            unpack = loop._unpack
            loop._unpack = lambda tree: unpack(tree)[:2] + (
                tmap(torch.zeros_like, unpack(tree)[2]),)
        recs = []
        loop.on_metrics = lambda step, rec: recs.append(rec)
        res = loop.run()
        return res, recs, loop._logger_meta()

    def snap(res):
        st = res["state"]
        return dict(master=npt(st.master), opt=npt(st.opt_state),
                    err=npt(res["wire_error"]),
                    ss=(res["scale_state"].amax_history.copy(),
                        res["scale_state"].scale.copy()))

    # A stop flag raised on rank 1 alone (as a signal would) stops both
    # ranks after the same step.
    loop = build_loop(arch="qwen2-1.5b", smoke=True, n_layers=2, steps=4,
                      batch=4, seq=32, recipe="hybrid",
                      ckpt_dir=os.path.join(root, "stop"),
                      checkpoint_every=0, plan=plan, device="cpu")

    def raise_on_rank1(step, rec):
        if rank == 1 and step == 0:
            loop._stop = True
    loop.on_metrics = raise_on_rank1
    out["stop_last_step"] = loop.run()["last_step"]
    full, recs, meta = run("full", 4)
    run("resumed", 2)
    resumed, _, _ = run("resumed", 4)
    run("faulty", 2)
    faulty, _, _ = run("faulty", 4, skip_err=True)
    out["loop"] = dict(full=snap(full), resumed=snap(resumed),
                       faulty=snap(faulty),
                       records=[{k: v for k, v in r.items()
                                 if k.startswith("comm/") or k in
                                 ("loss", "step", "span/allreduce_s")}
                                for r in recs],
                       meta_dist=meta.get("dist"),
                       last_step=(full["last_step"], resumed["last_step"]))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# ZeRO-1, the fp8 ZeRO gather and the "full" path's global batch
# (tests/test_torch_zero.py): `python tests/torch_dp_worker.py RANK WORKDIR
# zero`, inputs in WORKDIR/inputs.pkl.
# ---------------------------------------------------------------------------

def moe_cfg(inp):
    """The tiny moonshot (inputs' `moe_kw`) under the same recipe."""
    import dataclasses

    from repro_torch.core.precision_policy import QuantConfig
    from repro_torch.models.registry import build_config
    cfg = build_config("moonshot-v1-16b-a3b", smoke=True, **inp["moe_kw"])
    return cfg.replace(policy=dataclasses.replace(
        cfg.policy, quant=QuantConfig(**inp["quant_kw"])))


def zrun(mesh, inp, *, wire="full", zero1=True, gather="full", n_mb=1,
         rows="global", moe=False, steps=3):
    """`steps` steps of the port's step under a plan on `mesh` from the
    reference's weights. rows: "global" (the loop's rows: under "full"
    with microbatches, this rank's share of each global microbatch) or
    "contiguous" (the rank's contiguous shard split locally: the planted
    fault of the microbatch rows). Returns the metrics and the state,
    gathered whole, with this rank's shards."""
    from repro_torch.core.precision_policy import DistConfig
    from repro_torch.data.pipeline import host_shard, microbatch_shard
    from repro_torch.distributed.strategy import ParallelPlan
    from repro_torch.models.convert import from_jax_params
    from repro_torch.scaling.calibrate import discover_lm_sites
    from repro_torch.scaling.state import DelayedScaling
    from repro_torch.train.step import make_optimizer_for, make_train_step
    cfg = moe_cfg(inp) if moe else tiny_cfg(inp)
    key = "moe" if moe else "qwen"
    plan = ParallelPlan.build(mesh, DistConfig(
        wire=wire, zero1=zero1, tp=False, wire_zero_gather=gather))
    params = from_jax_params(inp["params_" + key], cfg, device="cpu")
    reg = discover_lm_sites(cfg, params, inp["probe_" + key])
    ds = DelayedScaling(reg, qcfg=cfg.policy.quant)
    opt = make_optimizer_for(cfg, learning_rate=1e-3)
    state, ss = opt.init(params), ds.init()
    if plan.zero1 is not None:
        state = plan.shard_state(state)
    err = plan.init_wire_state(state.master) if plan.compresses else None
    step = make_train_step(cfg, opt, scaling=ds, plan=plan,
                           n_microbatches=n_mb, device="cpu")
    mets = []
    for i, b in enumerate(inp["batches_" + key][:steps]):
        if n_mb > 1 and rows == "global" and not plan.compresses:
            local = microbatch_shard(b, plan.dp_rank, plan.dp_size, n_mb)
        else:
            local = host_shard(b, plan.dp_rank, plan.dp_size)
        gen = torch.Generator().manual_seed(i)
        if err is None:
            (state, ss), m = step(state, ss, local, gen)
        else:
            (state, ss, err), m = step(state, ss, err, local, gen)
        mets.append({k: v for k, v in m.items()
                     if not k.startswith("health/")})
    whole = plan.unshard_state(state) if plan.zero1 is not None else state
    digests = None
    if plan.zero1 is not None:
        # The launcher report's digest from the shards, and of the state
        # gathered whole.
        from repro_torch.launch.train import state_digest
        d = plan.zero_dims()
        tree = {"master": state.master, "opt_state": state.opt_state}
        digests = (state_digest(tree, plan, {"master": d,
                                             "opt_state": {"mu": d,
                                                           "nu": d}}),
                   state_digest({"master": whole.master,
                                 "opt_state": whole.opt_state}))
    return dict(metrics=mets, master=npt(whole.master), digests=digests,
                mu=npt(whole.opt_state["mu"]), nu=npt(whole.opt_state["nu"]),
                loss_scale={f: npt(getattr(whole.loss_scale, f))
                            for f in ("scale", "growth_count", "step",
                                      "overflow_count")},
                amax_history=ss.amax_history.copy(), scale=ss.scale.copy(),
                keys=list(reg.keys), shard=npt(state.master),
                dims=plan.zero_dims() if plan.zero1 is not None else None,
                zero_rank=plan.zero_rank, dp_rank=plan.dp_rank,
                err=npt(err) if err is not None else None)


def solo_step(inp, key):
    """The first step's metrics of the port's step without a plan, on the
    whole global batch (one process)."""
    from repro_torch.models.convert import from_jax_params
    from repro_torch.scaling.calibrate import discover_lm_sites
    from repro_torch.scaling.state import DelayedScaling
    from repro_torch.train.step import make_optimizer_for, make_train_step
    cfg = moe_cfg(inp) if key == "moe" else tiny_cfg(inp)
    params = from_jax_params(inp["params_" + key], cfg, device="cpu")
    reg = discover_lm_sites(cfg, params, inp["probe_" + key])
    ds = DelayedScaling(reg, qcfg=cfg.policy.quant)
    opt = make_optimizer_for(cfg, learning_rate=1e-3)
    step = make_train_step(cfg, opt, scaling=ds, device="cpu")
    _, m = step(opt.init(params), ds.init(), inp["batches_" + key][0],
                torch.Generator().manual_seed(0))
    return {k: v for k, v in m.items() if not k.startswith("health/")}


def gather_fixtures(mesh, inp, n):
    """The e4m3 gather of the inputs' fixture trees at N = n: each rank's
    shards gathered whole, and the zero_gather bytes comm counted."""
    from repro_torch.core.precision_policy import DistConfig
    from repro_torch.distributed import comm
    from repro_torch.distributed.strategy import ParallelPlan
    plan = ParallelPlan.build(mesh, DistConfig(
        wire="fp8_ef", wire_zero_gather="fp8", tp=False))
    from repro_torch.distributed import strategy
    out = {}
    for name, fix in inp["gather"][n].items():
        tree = {k: torch.from_numpy(v).to(torch.bfloat16)
                for k, v in fix.items()}
        plan.zero_dims(tree)
        comm.reset_counts()
        got = plan.gather_params(plan.shard(tree), fp8=True)
        out[name] = dict(
            got=npt(got), dims=plan.zero_dims(),
            bytes=comm.counts()["sent_bytes"].get("zero_gather", 0))
    # The planted fault: each rank's scale from its own shard alone.
    real = strategy.e4m3_gather_scales
    strategy.e4m3_gather_scales = lambda shards, group: [
        torch.clamp_min(x.float().abs().max() / 448.0, 1e-30)
        for x in shards]
    try:
        tree = {k: torch.from_numpy(v).to(torch.bfloat16)
                for k, v in inp["gather"][n]["pow2"].items()}
        plan.zero_dims(tree)
        out["pow2_fault"] = npt(plan.gather_params(plan.shard(tree),
                                                   fp8=True))
    finally:
        strategy.e4m3_gather_scales = real
    return out


def overflow_run(mesh, inp):
    """One ZeRO-1 "full" step whose reduce-scatter leaves an inf in rank
    1's shard of the first sharded leaf (a planted overflow): every rank
    must skip the step."""
    from repro_torch.distributed import comm
    real = comm.reduce_scatter
    hit = []

    def planted(x, dim, group):
        out = real(x, dim, group)
        if not hit:
            hit.append(True)
            if dist.get_rank() == 1:
                out.reshape(-1)[0] = float("inf")
        return out
    comm.reduce_scatter = planted
    try:
        return zrun(mesh, inp, steps=1)
    finally:
        comm.reduce_scatter = real


def zero_group(rank, workdir, inp, out):
    join(os.path.join(workdir, "zgroup"), rank, WORLD)
    flat = DeviceMesh("cpu", torch.arange(WORLD), mesh_dim_names=("data",))
    grid = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2),
                      mesh_dim_names=("pod", "data"))
    out["gather"] = {4: gather_fixtures(flat, inp, 4),
                     2: gather_fixtures(grid, inp, 2)}
    runs = out["runs4"] = {}
    runs["mb2"] = zrun(flat, inp, zero1=False, n_mb=2)
    runs["mb2_contiguous"] = zrun(flat, inp, zero1=False, n_mb=2,
                                  rows="contiguous")
    runs["moe"] = zrun(flat, inp, zero1=False, moe=True)
    out["moe_solo"] = solo_step(inp, "moe")
    for wire in ("full", "fp8_ef"):
        for z in (False, True):
            runs[f"{wire}/{z}"] = zrun(flat, inp, wire=wire, zero1=z)
    runs["full/True/fp8"] = zrun(flat, inp, zero1=True, gather="fp8")
    runs["grid_fp8_gather"] = zrun(grid, inp, wire="fp8_ef", gather="fp8")
    runs["overflow"] = overflow_run(flat, inp)
    dist.destroy_process_group()


def zero_pair(rank, workdir, inp, out):
    """Ranks 0 and 1: ZeRO-1 on against off at N = 2 on both wires; the
    TrainLoop's resume under ZeRO-1 and the elastic restores."""
    from repro_torch.launch.train import build_loop, build_plan
    join(os.path.join(workdir, "zpair"), rank, 2)
    pair_mesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("data",))
    runs = out["runs2"] = {}
    for wire in ("full", "fp8_ef"):
        for z in (False, True):
            runs[f"{wire}/{z}"] = zrun(pair_mesh, inp, wire=wire, zero1=z)
    root = os.path.join(workdir, "zloops")
    plans = {z: build_plan(2, "gloo", "cpu", wire="fp8_ef", zero1=z)
             for z in (False, True)}

    def run(name, total, zero1):
        loop = build_loop(arch="qwen2-1.5b", smoke=True, n_layers=2,
                          steps=total, batch=4, seq=32, recipe="hybrid",
                          ckpt_dir=os.path.join(root, name),
                          checkpoint_every=2, log_every=2,
                          plan=plans[zero1], device="cpu")
        res = loop.run()
        st = res["state"]
        if zero1:
            st = plans[True].unshard_state(st)
        return dict(master=npt(st.master), opt=npt(st.opt_state),
                    loss_scale=npt(vars(st.loss_scale)),
                    err=npt(res["wire_error"]),
                    ss=(res["scale_state"].amax_history.copy(),
                        res["scale_state"].scale.copy()),
                    last_step=res["last_step"])

    loops = out["loops"] = {}
    loops["on"] = run("on", 4, True)
    run("on_resumed", 2, True)
    loops["on_resumed"] = run("on_resumed", 4, True)
    run("off_then_on", 2, False)
    loops["off_then_on"] = run("off_then_on", 4, True)
    run("on_then_off", 2, True)
    loops["on_then_off"] = run("on_then_off", 4, False)
    dist.barrier()
    ck = os.path.join(root, "on", "step_0000000004", "leaves.npz")
    with np.load(ck) as data:
        out["ckpt_shapes"] = {k: data[k].shape for k in data.files}
    dist.destroy_process_group()


def zero_main(rank, workdir):
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {}
    try:
        zero_group(rank, workdir, inp, out)
        if rank < 2:
            zero_pair(rank, workdir, inp, out)
    except BaseException:
        out["error"] = traceback.format_exc()
    out["jax_loaded"] = "jax" in sys.modules
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def main(rank, workdir):
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {}
    try:
        solo(rank, workdir, inp, out)
        group(rank, workdir, inp, out)
        if rank < 2:
            pair(rank, workdir, inp, out)
    except BaseException:
        out["error"] = traceback.format_exc()
    out["jax_loaded"] = "jax" in sys.modules
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# Tensor parallelism (tests/test_torch_tp.py): `python tests/torch_dp_worker.py
# RANK WORKDIR tp`, inputs in WORKDIR/inputs.pkl.
# ---------------------------------------------------------------------------

# The runs' recipes: the port's config's QuantConfig keywords.
TP_QUANT = {
    "rne": dict(recipe="hybrid", scaling="delayed", backend="pallas",
                track_health=True, act_rounding="rne", error_rounding="rne",
                grad_rounding="rne"),
    "sr": dict(recipe="hybrid", scaling="delayed", backend="pallas",
               track_health=True),
    "paper": dict(backend="pallas"),
}


def tp_cfg(inp, quant="rne", **over):
    import dataclasses

    from repro_torch.core.precision_policy import QuantConfig
    from repro_torch.models.registry import build_config
    cfg = build_config("qwen2-1.5b", smoke=True, **dict(inp["cfg_kw"], **over))
    return cfg.replace(policy=dataclasses.replace(
        cfg.policy, quant=QuantConfig(**TP_QUANT[quant])))


def _tree_rows(tree, dims):
    """{path: array} of the leaves whose dim is None (replicated)."""
    out = {}

    def walk(t, d, pre):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], d[k] if d is not None else None, f"{pre}/{k}")
        elif d is None:
            out[pre] = npt(t)
    walk(tree, dims, "")
    return out


def tprun(mesh, inp, quant="rne", *, zero1=False, n_mb=1, steps=2,
          fault=None, **over):
    """`steps` steps of the port's step under a TP plan on `mesh`, from the
    reference's weights, on this rank's dp rows of the inputs' global
    batches; the master gathered whole after each step. fault: "qsum"
    (each rank's row-parallel partial quantized, the payloads summed) or
    "local_amax" (the observations not combined over 'model')."""
    from repro_torch.core.precision_policy import DistConfig
    from repro_torch.data.pipeline import host_shard
    from repro_torch.distributed import comm
    from repro_torch.distributed.strategy import ParallelPlan
    from repro_torch.models.convert import from_jax_params
    from repro_torch.scaling.calibrate import discover_lm_sites
    from repro_torch.scaling.state import DelayedScaling
    from repro_torch.train.step import make_optimizer_for, make_train_step
    cfg = tp_cfg(inp, quant, **over)
    plan = ParallelPlan.build(mesh, DistConfig(zero1=zero1))
    params = from_jax_params(inp["params"], cfg, device="cpu")
    ds = None
    if cfg.policy.quant.delayed:
        ds = DelayedScaling(discover_lm_sites(cfg, params, inp["probe"]),
                            qcfg=cfg.policy.quant)
    opt = make_optimizer_for(cfg, learning_rate=1e-3)
    state = plan.shard_state(opt.init(params))
    ss = ds.init() if ds else None
    step = make_train_step(cfg, opt, scaling=ds, plan=plan,
                           n_microbatches=n_mb, device="cpu")
    out = dict(metrics=[], masters=[], amax=[], keys=list(ds.registry.keys)
               if ds else None, sent={})
    with planted(fault):
        for i, b in enumerate(inp["batches"][:steps]):
            b = host_shard(b, plan.dp_rank, plan.dp_size)
            gen = torch.Generator().manual_seed(i)
            comm.reset_counts()
            if ds is None:
                state, m = step(state, b, gen)
            else:
                (state, ss), m = step(state, ss, b, gen)
                out["amax"].append(ss.amax_history[:, 0].copy())
            for k, v in comm.counts()["sent_bytes"].items():
                out["sent"][k] = out["sent"].get(k, 0) + v
            out["metrics"].append(m)
            out["masters"].append(npt(plan.unshard_state(state).master))
    out["local_repl"] = _tree_rows(state.master, plan.tp_dims())
    out["loss_scale"] = npt(vars(state.loss_scale))
    out["scale"] = ss.scale.copy() if ss is not None else None
    out["tp_rank"], out["dp_rank"] = plan.tp_rank, plan.dp_rank
    return out


def solo_run(inp, quant="rne", *, n_mb=1, steps=2, **over):
    """tprun's steps in one process without a plan, on the whole global
    batches."""
    from repro_torch.models.convert import from_jax_params
    from repro_torch.scaling.calibrate import discover_lm_sites
    from repro_torch.scaling.state import DelayedScaling
    from repro_torch.train.step import make_optimizer_for, make_train_step
    cfg = tp_cfg(inp, quant, **over)
    params = from_jax_params(inp["params"], cfg, device="cpu")
    ds = None
    if cfg.policy.quant.delayed:
        ds = DelayedScaling(discover_lm_sites(cfg, params, inp["probe"]),
                            qcfg=cfg.policy.quant)
    opt = make_optimizer_for(cfg, learning_rate=1e-3)
    state, ss = opt.init(params), ds.init() if ds else None
    step = make_train_step(cfg, opt, scaling=ds, n_microbatches=n_mb,
                           device="cpu")
    out = dict(metrics=[], masters=[], amax=[], keys=list(ds.registry.keys)
               if ds else None, p0=npt(state.master))
    for i, b in enumerate(inp["batches"][:steps]):
        gen = torch.Generator().manual_seed(i)
        if ds is None:
            state, m = step(state, b, gen)
        else:
            (state, ss), m = step(state, ss, b, gen)
            out["amax"].append(ss.amax_history[:, 0].copy())
        out["metrics"].append(m)
        out["masters"].append(npt(state.master))
    return out


class planted:
    """The planted faults of tprun, patched in for the block."""

    def __init__(self, fault):
        self.fault = fault

    def __enter__(self):
        from repro_torch.core import qlinear
        from repro_torch.scaling.context import ScaleContext
        self.saved = (qlinear._summed_gemm, ScaleContext.tp_combine)
        if self.fault == "qsum":
            qlinear._summed_gemm = quantize_then_sum
        elif self.fault == "local_amax":
            ScaleContext.tp_combine = lambda self, rows_of: None
        elif self.fault is not None:
            raise ValueError(self.fault)

    def __exit__(self, *exc):
        from repro_torch.core import qlinear
        from repro_torch.scaling.context import ScaleContext
        qlinear._summed_gemm, ScaleContext.tp_combine = self.saved
        return False


def quantize_then_sum(x8, w8, sx, sw, s_out, cfg, out_cls, generator, tp):
    """The planted fault of a row-parallel site: each rank's partial
    through the Q node, the payloads summed over the ranks, the sum
    quantized again (the Megatron order)."""
    from repro_torch.core.qlinear import _q_node, _rand8
    from repro_torch.core.quantize import f32
    from repro_torch.distributed import tensor_parallel
    from repro_torch.kernels.fp8_matmul import ops as mm_ops
    part = mm_ops.fp8_matmul(x8, w8)
    q, _, _ = _q_node(part, f32(s_out) / (f32(sx) * f32(sw)), cfg, out_cls,
                      _rand8(part.shape, cfg, out_cls, generator))
    total = tensor_parallel.rank_sum(q.float(), tp)
    q, amax, health = _q_node(total, f32(1.0), cfg, out_cls,
                              _rand8(total.shape, cfg, out_cls, generator))
    return q, amax * float(f32(s_out)), health


def vocab_pieces(tpg, inp):
    """The vocab-parallel embedding and cross-entropy on this rank's shard
    of a table, against the whole table in this process: the lookup and
    its table gradient, the CE's sum and dh."""
    from repro_torch.core.precision_policy import QuantConfig
    from repro_torch.distributed import tensor_parallel
    from repro_torch.models.layers import embed
    from repro_torch.models.transformer import _chunked_ce
    cfg = tp_cfg(inp)
    v, d = cfg.padded_vocab_size, cfg.d_model
    g = torch.Generator().manual_seed(11)
    table = torch.randn(v, d, generator=g).to(torch.bfloat16)
    h = torch.randn(4, 32, d, generator=g).to(torch.bfloat16)
    tokens = torch.randint(0, v, (4, 32), generator=g)
    mask = (torch.rand(4, 32, generator=g) > 0.2).float()
    sl = slice(tpg.rank * v // tpg.size, (tpg.rank + 1) * v // tpg.size)
    head_cfg = QuantConfig(enabled=False)
    res = {}
    for name, tp in (("tp", tpg), ("whole", None)):
        t = (table[sl] if tp else table).clone().requires_grad_(True)
        hh = h.clone().requires_grad_(True)
        with tensor_parallel.active(tp and tp.with_layout([(t, 0)])):
            e = embed({"table": t}, tokens)
            e.float().square().sum().backward()
            emb_grad = t.grad.clone()
            t.grad = None
            ce = _chunked_ce({"embed": {"table": t}}, hh, tokens, mask,
                             cfg=cfg, head_cfg=head_cfg, chunk=16)
            ce.backward()
        res[name] = dict(embed=npt(e), embed_grad=npt(emb_grad),
                         ce=float(ce), dh=npt(hh.grad),
                         table_grad=npt(t.grad))
    res["rows"] = (sl.start, sl.stop)
    return res


def tp_loops(rank, plan, workdir, inp):
    """The TrainLoop under a TP plan: 4 steps against 2 + a restore + 2,
    the state gathered whole."""
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
    from repro_torch.scaling.calibrate import discover_lm_sites
    from repro_torch.scaling.state import DelayedScaling
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.step import make_optimizer_for
    cfg = tp_cfg(inp)
    root = os.path.join(workdir, "tploops")

    def run(name, total, p):
        ds = DelayedScaling(discover_lm_sites(
            cfg, init_lm(cfg, device="cpu"), inp["probe"]),
            qcfg=cfg.policy.quant)
        opt = make_optimizer_for(cfg, learning_rate=1e-3)
        data = lambda s: synthetic_lm_batches(DataConfig(  # noqa: E731
            vocab_size=cfg.vocab_size, seq_len=32, batch_size=4),
            start_step=s)
        loop = TrainLoop(cfg, opt, data, LoopConfig(
            total_steps=total, checkpoint_every=2,
            checkpoint_dir=os.path.join(root, name), log_every=100),
            scaling=ds, plan=p, device="cpu")
        res = loop.run()
        st = p.unshard_state(res["state"]) if p is not None \
            else res["state"]
        return dict(master=npt(st.master), opt=npt(st.opt_state),
                    ss=res["scale_state"].amax_history.copy(),
                    last=res["last_step"],
                    repl=_tree_rows(res["state"].master, p.tp_dims())
                    if p is not None else None)

    out = {"full": run("full", 4, plan)}
    run("resumed", 2, plan)
    out["resumed"] = run("resumed", 4, plan)
    dist.barrier()
    if rank == 0:
        # The (1, 2) checkpoint of step 4 restored in one process.
        out["solo_restore"] = run("full", 4, None)
        with np.load(os.path.join(root, "full", "step_0000000004",
                                  "leaves.npz")) as data:
            out["ckpt_shapes"] = {k: data[k].shape for k in data.files}
    return out


def tp_group4(rank, workdir, inp, out):
    """All four ranks: the misaligned heads on (1, 4), then (2, 2) with
    ZeRO-1 on and off."""
    join(os.path.join(workdir, "tpgroup"), rank, WORLD)
    m14 = DeviceMesh("cpu", torch.arange(WORLD).reshape(1, 4),
                     mesh_dim_names=("data", "model"))
    m22 = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2),
                     mesh_dim_names=("data", "model"))
    runs = out["runs"]
    runs["1x4"] = tprun(m14, inp)
    runs["2x2/zero"] = tprun(m22, inp, zero1=True)
    runs["2x2/nozero"] = tprun(m22, inp, zero1=False)
    dist.destroy_process_group()


def tp_pair(rank, workdir, inp, out):
    """Ranks 0 and 1 on (1, 2): the recipes, the options, the faults, the
    vocab-parallel pieces and the TrainLoop."""
    from repro_torch.core.precision_policy import DistConfig
    from repro_torch.distributed import tensor_parallel
    from repro_torch.distributed.strategy import ParallelPlan
    join(os.path.join(workdir, "tppair"), rank, 2)
    mesh = DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                      mesh_dim_names=("data", "model"))
    runs = out["runs"]
    runs["1x2"] = tprun(mesh, inp)
    runs["1x2/sr"] = tprun(mesh, inp, "sr")
    runs["1x2/paper"] = tprun(mesh, inp, "paper")
    runs["1x2/mb2"] = tprun(mesh, inp, n_mb=2)
    runs["1x2/remat"] = tprun(mesh, inp, remat=True)
    runs["1x2/qsum"] = tprun(mesh, inp, steps=1, fault="qsum")
    runs["1x2/local_amax"] = tprun(mesh, inp, steps=1, fault="local_amax")
    plan = ParallelPlan.build(mesh, DistConfig(zero1=False))
    tpg = tensor_parallel.TPGroup(plan.tp_group(), plan.tp_rank,
                                  plan.tp_size)
    out["vocab"] = vocab_pieces(tpg, inp)
    out["archs"] = {f"{a}/{q}": arch_case(mesh, inp, a, q)
                    for a in DENSE_ARCHS for q in ("rne", "paper")}
    out["loops"] = tp_loops(rank, plan, workdir, inp)
    dist.destroy_process_group()


DENSE_ARCHS = ("codeqwen1.5-7b", "internlm2-20b", "mistral-large-123b",
               "llava-next-34b")


def arch_case(mesh, inp, arch, quant):
    """One step of a dense config (smoke width, 2 layers) under a TP plan
    on `mesh` and in this process without a plan, from the same weights,
    batch and seed (llava's with a 4-row patch prefix): the two losses and
    the update's rel L2 of the TP step against the one-process step."""
    import dataclasses

    from repro_torch.core.precision_policy import DistConfig, QuantConfig
    from repro_torch.distributed.strategy import ParallelPlan
    from repro_torch.models.registry import build_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.scaling.calibrate import discover_lm_sites
    from repro_torch.scaling.state import DelayedScaling
    from repro_torch.train.step import make_optimizer_for, make_train_step
    cfg = build_config(arch, smoke=True, n_layers=2, remat=False)
    cfg = cfg.replace(policy=dataclasses.replace(
        cfg.policy, quant=QuantConfig(**TP_QUANT[quant])))
    batch = dict(inp["batches"][0])
    if arch.startswith("llava"):
        rng = np.random.default_rng(3)
        batch["extra_embeds"] = rng.standard_normal(
            (8, 4, cfg.d_model)).astype(np.float32)
    res = []
    for plan in (ParallelPlan.build(mesh, DistConfig(zero1=False)), None):
        params = init_lm(cfg, seed=0, device="cpu")
        opt = make_optimizer_for(cfg, learning_rate=1e-3)
        state = opt.init(params)
        p0 = npt(state.master)
        if plan is not None:
            state = plan.shard_state(state)
        ds = DelayedScaling(discover_lm_sites(cfg, params, inp["probe"]),
                            qcfg=cfg.policy.quant) \
            if cfg.policy.quant.delayed else None
        step = make_train_step(cfg, opt, scaling=ds, plan=plan, device="cpu")
        gen = torch.Generator().manual_seed(0)
        if ds is None:
            state, m = step(state, batch, gen)
        else:
            (state, _), m = step(state, ds.init(), batch, gen)
        whole = plan.unshard_state(state) if plan is not None else state
        res.append((m["loss"], npt(whole.master)))
    (lt, mt), (lo, mo) = res

    def flat(t):
        return np.concatenate([np.ravel(v) for v in _tree_rows(t, None)
                               .values()]).astype(np.float64)
    z = flat(p0)
    du = flat(mt) - z
    dw = flat(mo) - z
    return dict(loss_tp=lt, loss_one=lo,
                update_rel=float(np.linalg.norm(du - dw)
                                 / max(np.linalg.norm(dw), 1e-30)))


def tp_solo(rank, inp, out):
    """Ranks 2 and 3 while 0 and 1 run the pair: the one-process runs."""
    runs = out["solo"]
    if rank == 2:
        runs["rne"] = solo_run(inp)
        runs["sr"] = solo_run(inp, "sr")
    else:
        runs["paper"] = solo_run(inp, "paper")
        runs["mb2"] = solo_run(inp, n_mb=2)


def tp_main(rank, workdir):
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {"runs": {}, "solo": {}}
    try:
        tp_group4(rank, workdir, inp, out)
        if rank < 2:
            tp_pair(rank, workdir, inp, out)
        else:
            tp_solo(rank, inp, out)
    except BaseException:
        out["error"] = traceback.format_exc()
    out["jax_loaded"] = "jax" in sys.modules
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    if sys.argv[3:] == ["zero"]:
        zero_main(int(sys.argv[1]), sys.argv[2])
    elif sys.argv[3:] == ["tp"]:
        tp_main(int(sys.argv[1]), sys.argv[2])
    else:
        main(int(sys.argv[1]), sys.argv[2])
