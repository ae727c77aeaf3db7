"""Fault-tolerant training loop (counterpart of `repro.train.loop`).

 * checkpoint/restart — periodic async checkpoints (atomic commit),
   restore on start from the newest committed step; a killed and
   relaunched run resumes where it stopped. The data source is a function
   of the step (a callable seeks; an iterator is fast-forwarded) and each
   step's SR generator is seeded from (seed, step), so a resumed run
   computes what an uninterrupted one does.
 * preemption — SIGTERM / SIGINT set a "stop after this step" flag; the
   loop checkpoints and stops.
 * stragglers — an EMA of the step's wall time; a step slower than
   `straggler_factor` x EMA is counted and passed to `on_straggler`. The
   EMA and the count ride the checkpoint manifest, so a resumed run keeps
   its baseline.
 * observability — each step's phases run inside `obs.trace.Tracer`
   spans (data_wait, step_dispatch, device_sync, checkpoint), records go
   through `obs.metrics.MetricsLogger` (versioned jsonl), and
   `obs.health.HealthMonitor` attaches `health_events` to the record that
   triggered them. `on_metrics` sees every serialized record.

The step is `train.step.make_train_step` on `device` (CUDA unless the
caller asks for the CPU). With `scaling` (a DelayedScaling) its ScaleState
is checkpointed beside the optimizer state.

Data parallelism (`plan`, a `distributed.strategy.ParallelPlan`; the loop
runs on every rank of its mesh): each rank takes its slice of every global
batch (`data.pipeline.host_shard` at `plan.dp_rank`; under a "full" plan
with several microbatches `data.pipeline.microbatch_shard`, its share of
each of the reference's microbatches). When the plan
compresses (wire "fp8_ef") the error-feedback residual rides the step like
ScaleState: checkpointed under "wire_error" in the reference's layout (the
wire's ranks stacked on a leading axis, gathered for the save; each rank
restores its own slot), returned by `run()`, and timed by a sampled
`allreduce` span (the wire collective on the residual, every `log_every`
steps). Records carry the modeled `comm/*` bytes of `plan.wire_bytes` and
the bytes `distributed.comm` counted in the step (`comm/sent_payload_bytes`,
`comm/sent_reduce_bytes`, `comm/sent_zero_gather_bytes`,
`comm/staged_bytes`). Rank 0 alone writes the checkpoint and the metrics
file; the ranks meet at a barrier after the last save, and a preemption
signal that reaches any rank stops them all after the same step.

ZeRO-1 (plan.zero1) and tensor parallelism (plan.tp): each rank
initializes the whole state, keeps its shards (`plan.shard_state`: its
'model' chunk, and of that its 'data' chunk) and trains them; the ranks
of a 'model' group take the same rows of every global batch (the batch
is sliced by the rank's dp coordinates alone). The checkpoint keeps the
reference's layout, whole arrays: every rank takes part in gathering the
master weights and the moments (`plan.unshard_state`, over 'data', then
'model') and rank 0 writes them; on restore every rank reads the whole
arrays and keeps its slice. A checkpoint restores onto any mesh (and
onto one process), whatever mesh wrote it. `run()` returns this rank's
sharded state.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.core.master_weights import MixedPrecisionOptimizer
from repro_torch.data.pipeline import host_shard, microbatch_shard
from repro_torch.device import resolve_device
from repro_torch.distributed import comm
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import stack_wire_error, unstack_wire_error
from repro_torch.models.transformer import init_lm
from repro_torch.obs.health import HealthConfig, HealthMonitor
from repro_torch.obs.metrics import MetricsLogger, jsonable
from repro_torch.obs.trace import Tracer
from repro_torch.optim.optimizers import tmap
from repro_torch.scaling.state import DelayedScaling
from repro_torch.train.step import make_train_step


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    # Steps between checkpoints (and one at the end and on preemption);
    # 0 turns checkpointing off.
    checkpoint_every: int = 50
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch_ckpt")
    keep_last_k: int = 3
    log_every: int = 10
    metrics_path: Optional[str] = None
    trace_path: Optional[str] = None
    metrics_window: int = 64
    straggler_factor: float = 3.0
    straggler_ema: float = 0.95
    n_microbatches: int = 1


def step_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s SR generator: a function of (seed, step)
    alone (the reference's fold_in(PRNGKey(seed + 17), step))."""
    return int(np.random.SeedSequence([seed + 17, step]).generate_state(
        1, np.uint64)[0] >> 1)


class TrainLoop:
    def __init__(self, cfg: ModelConfig, optimizer: MixedPrecisionOptimizer,
                 data, loop: LoopConfig, *, seed: int = 0,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 on_metrics: Optional[
                     Callable[[int, Dict[str, Any]], None]] = None,
                 health: Optional[HealthConfig] = None,
                 scaling: Optional[DelayedScaling] = None,
                 amax_sync=None, plan=None, device=None):
        """data: an iterator of global batches, or a callable
        data(start_step) returning one that starts at that step.
        on_metrics(step, record): every serialized record (health_events
        included). plan / amax_sync: as make_train_step takes them (module
        docstring)."""
        self.cfg = cfg
        self.optimizer = optimizer
        self.data = data
        self.loop = loop
        self.seed = seed
        self.on_straggler = on_straggler
        self.on_metrics = on_metrics
        self.scaling = scaling
        self.plan = plan
        self.device = resolve_device(device)
        # Built first: it refuses what the plan asks that is not ported.
        self._step_fn = make_train_step(
            cfg, optimizer, n_microbatches=loop.n_microbatches,
            scaling=scaling, amax_sync=amax_sync, plan=plan,
            device=self.device)
        self.wire = plan is not None and plan.compresses
        self.shard = plan is not None and plan.dp is not None \
            and plan.dp_size > 1
        self.zero = plan is not None and plan.zero1 is not None
        # The state is held as this rank's shards (ZeRO-1 over 'data',
        # tensor parallelism over 'model').
        self.sharded = self.zero or (plan is not None
                                     and plan.tp is not None)
        self.rank0 = not dist.is_initialized() or dist.get_rank() == 0
        self.ckpt = Checkpointer(loop.checkpoint_dir,
                                 keep_last_k=loop.keep_last_k)
        self._stop = False
        # The wire collective alone, timed every log_every steps on the
        # (gradient-shaped) residual under the `allreduce` span.
        self._wire_probe = plan.dp_allreduce() if self.wire else None
        self._comm: Dict[str, float] = {}
        self.tracer = Tracer(loop.trace_path)
        self.monitor = HealthMonitor(
            health,
            site_names=list(scaling.registry.keys) if scaling else None,
            scaler=optimizer.scaler)

    def _logger_meta(self) -> Dict[str, Any]:
        quant = self.cfg.policy.quant
        meta: Dict[str, Any] = {
            "arch": self.cfg.arch,
            "n_microbatches": self.loop.n_microbatches,
            "total_steps": self.loop.total_steps,
            "recipe": quant.recipe,
            "track_health": bool(quant.track_health),
        }
        if self.scaling is not None:
            # Row order of the dense health/amax_sites vector.
            meta["sites"] = list(self.scaling.registry.keys)
        if self.plan is not None:
            meta["dist"] = self.plan.describe()
        return meta

    def install_signal_handlers(self):
        def handler(signum, frame):  # noqa: ARG001
            print(f"[train] signal {signum}: will checkpoint and stop "
                  "after the current step")
            self._stop = True
        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    def _pack(self, state, scale_state, err=None):
        """The checkpoint's tree; `err` is the residual in the stacked
        layout."""
        if self.scaling is None and not self.wire:
            return state
        tree = {"train": state}
        if self.scaling is not None:
            tree["amax_scales"] = scale_state
        if self.wire:
            tree["wire_error"] = err
        return tree

    def _unpack(self, tree):
        if self.scaling is None and not self.wire:
            return tree, None, None
        return (tree["train"], tree.get("amax_scales"),
                tree.get("wire_error"))

    def _stacked_error(self, err):
        """Every wire rank's residual, stacked (one all-gather a leaf over
        the wire group; each rank takes part, rank 0 saves)."""
        group = self.plan.group(self.plan.wire_axis)
        return tmap(lambda e: comm.all_gather(e, group), err)

    def _save(self, step, state, scale_state, err, extra):
        stacked = self._stacked_error(err) if self.wire else None
        if self.sharded:
            state = self.plan.unshard_state(state, to_host=True)
        if self.rank0:
            self.ckpt.save(step, self._pack(state, scale_state, stacked),
                           extra=extra)
        del stacked, state

    def _restore_target(self, state):
        """A whole-layout state to restore into: for a sharded state host
        tensors of the whole shapes (the checkpoint holds whole arrays)."""
        if not self.sharded:
            return state
        shapes = self.plan.full_shapes(state.master)

        def whole(x, s):
            return torch.empty(s, dtype=x.dtype)
        from repro_torch.core.master_weights import MixedPrecisionState
        opt = {k: (tmap(whole, v, shapes) if k in ("mu", "nu") else v)
               for k, v in state.opt_state.items()}
        return MixedPrecisionState(master=tmap(whole, state.master, shapes),
                                   opt_state=opt,
                                   loss_scale=state.loss_scale)

    def _keep_slice(self, state, whole):
        """Copy this rank's slice of the restored whole state into its
        shards (in place)."""
        mine = self.plan.shard_state(whole)
        tmap(lambda s, w: s.copy_(w), state.master, mine.master)
        for k in ("mu", "nu"):
            if k in state.opt_state:
                tmap(lambda s, w: s.copy_(w), state.opt_state[k],
                     mine.opt_state[k])
        opt = dict(whole.opt_state)
        for k in ("mu", "nu"):
            if k in opt:
                opt[k] = state.opt_state[k]
        return dataclasses.replace(state, opt_state=opt,
                                   loss_scale=whole.loss_scale)

    def run(self) -> Dict[str, Any]:
        path = self.loop.metrics_path if self.rank0 else None
        with MetricsLogger(path, meta=self._logger_meta(),
                           window=self.loop.metrics_window) as logger:
            try:
                return self._run(logger)
            finally:
                self.tracer.export()

    def _run(self, logger: MetricsLogger) -> Dict[str, Any]:
        dev = self.device
        state = self.optimizer.init(init_lm(self.cfg, seed=self.seed,
                                            device=dev))
        if self.sharded:
            state = self.plan.shard_state(state)
        scale_state = self.scaling.init() if self.scaling else None
        err = self.plan.init_wire_state(state.master) if self.wire else None
        if self.wire:
            self._comm = {f"comm/{k}": v for k, v in
                          self.plan.wire_bytes(
                              self.plan.full_shapes(state.master)).items()
                          if isinstance(v, (int, float))}
        start_step = 0
        ema = None
        stragglers = 0
        if self.ckpt.latest_step() is not None:
            stacked = stack_wire_error([err] * self.plan.n_wire) \
                if self.wire else None
            tree, start_step = self.ckpt.restore(
                self._pack(self._restore_target(state), scale_state,
                           stacked))
            whole, scale_state, stacked = self._unpack(tree)
            state = self._keep_slice(state, whole) if self.sharded \
                else whole
            del whole
            if self.wire:
                # This rank's slot of the stacked residual, in its own
                # tensors.
                tmap(lambda e, s: e.copy_(s), err,
                      unstack_wire_error(stacked, self.plan.wire_rank))
                del stacked
            extra = self.ckpt.manifest(start_step).get("extra", {}) or {}
            ema = extra.get("straggler_ema")
            stragglers = int(extra.get("stragglers", 0))
            print(f"[train] restored checkpoint at step {start_step}")
            # Fast-forward the data to the batches an uninterrupted run
            # would consume next; a callable source seeks directly.
            if callable(self.data):
                self.data = self.data(start_step)
            else:
                for _ in range(start_step):
                    next(self.data)
        elif callable(self.data):
            self.data = self.data(0)

        last_metrics: Dict[str, Any] = {}
        step = start_step
        for step in range(start_step, self.loop.total_steps):
            t0 = time.time()
            with self.tracer.span("data_wait", step=step):
                batch = next(self.data)
                n_mb = self.loop.n_microbatches
                if self.shard and not self.wire and n_mb > 1:
                    batch = microbatch_shard(batch, self.plan.dp_rank,
                                             self.plan.dp_size, n_mb)
                elif self.shard:
                    batch = host_shard(batch, self.plan.dp_rank,
                                       self.plan.dp_size)
            gen = torch.Generator(device=dev).manual_seed(
                step_seed(self.seed, step))
            sent0 = comm.counts()
            with self.tracer.span("step_dispatch", step=step):
                if self.wire and self.scaling is None:
                    (state, err), metrics = self._step_fn(
                        state, err, batch, gen)
                elif self.wire:
                    (state, scale_state, err), metrics = self._step_fn(
                        state, scale_state, err, batch, gen)
                elif self.scaling is None:
                    state, metrics = self._step_fn(state, batch, gen)
                else:
                    (state, scale_state), metrics = self._step_fn(
                        state, scale_state, batch, gen)
            with self.tracer.span("device_sync", step=step):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            counted = _count_delta(sent0, comm.counts()) \
                if self.shard or self.sharded else {}
            if self.wire and step % self.loop.log_every == 0:
                # Sampled wire-collective timing: the residual is exactly
                # gradient-shaped, so reducing it runs the real collective
                # (its result discarded, the residual untouched).
                with self.tracer.span("allreduce", step=step):
                    self._wire_probe(err, err)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
            # One reading of the stop flag decides this step's save and
            # stop. A signal may reach the ranks at different steps: under
            # a plan they stop together, after the first step at whose
            # reading any of them had seen it.
            stop = self._stop
            if self.plan is not None and dist.is_initialized():
                flag = torch.full((1,), float(stop), device=dev)
                stop = bool(comm.all_reduce(flag, "max",
                                            dist.group.WORLD)[0])
            dt = time.time() - t0
            # Straggler detection (the first step of a run is a warm-up).
            if step > start_step:
                if ema is not None and dt > self.loop.straggler_factor * ema:
                    stragglers += 1
                    print(f"[train] straggler step {step}: {dt:.3f}s vs "
                          f"EMA {ema:.3f}s")
                    if self.on_straggler:
                        self.on_straggler(step, dt)
                ema = dt if ema is None else \
                    self.loop.straggler_ema * ema \
                    + (1 - self.loop.straggler_ema) * dt

            done = step + 1 >= self.loop.total_steps
            every = self.loop.checkpoint_every
            save = every > 0 and (stop or done or (step + 1) % every == 0)
            if save:
                with self.tracer.span("checkpoint", step=step):
                    self._save(step + 1, state, scale_state, err,
                               extra={"straggler_ema": ema,
                                      "stragglers": stragglers})

            # Serialize first, then let the detectors see the exact record,
            # so events land on the record whose metrics triggered them.
            record = {k: jsonable(v) for k, v in metrics.items()}
            record.update(step=step, step_time_s=round(dt, 4),
                          stragglers=stragglers, **self._comm, **counted,
                          **self.tracer.durations())
            events = self.monitor.observe(step, record)
            if events:
                record["health_events"] = events
            record = logger.log(record)
            if self.on_metrics:
                self.on_metrics(step, record)
            last_metrics = record
            if step % self.loop.log_every == 0:
                # Non-finite metrics serialize as strings ("inf" / "nan").
                loss = record.get("loss", 0)
                scale = record.get("loss_scale", 0)
                loss = f"{loss:.4f}" if isinstance(loss, float) else loss
                scale = f"{scale:.0f}" if isinstance(scale, float) else scale
                print(f"[train] step {step} loss={loss} scale={scale} "
                      f"t={dt:.3f}s")
            if stop:
                print(f"[train] preempted: "
                      f"{'checkpointed' if save else 'stopped'} at {step + 1}")
                break
        self.ckpt.wait()
        if dist.is_initialized() and self.plan is not None:
            # No rank reads the directory before rank 0's last write ends.
            dist.barrier()
        return {"state": state, "scale_state": scale_state,
                "wire_error": err, "last_step": step + 1,
                "metrics": last_metrics, "stragglers": stragglers}


def _count_delta(before: Dict, after: Dict) -> Dict[str, float]:
    """The bytes `distributed.comm` counted between two readings, as
    comm/* record entries."""
    out = {f"comm/sent_{k}_bytes": v - before["sent_bytes"].get(k, 0)
           for k, v in after["sent_bytes"].items()}
    out["comm/staged_bytes"] = after["staged_bytes"] - before["staged_bytes"]
    return out
