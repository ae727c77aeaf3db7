"""Composable parallelism strategies -> one ParallelPlan (counterpart of
`repro.distributed.strategy`).

Three strategy objects compose into a `ParallelPlan` built from a
`torch.distributed.device_mesh.DeviceMesh` (dims named 'pod', 'data',
'model') and `policy.dist`:

  * DataParallel   — the batch over ('pod', 'data'), gradients reduced
  * ZeRO1Sharded   — master weights and optimizer moments over 'data'
  * TensorParallel — parameters sharded over 'model'

`build` makes the reference's decisions from the mesh's dim names and
sizes, and the plan's axis bookkeeping is the reference's. Its process
groups come from the mesh. The data-parallel reduction's wire format:

  policy.dist.wire = "full" | "fp8_ef"
      "fp8_ef" sends the gradient reduction over the wire axis (the
      slowest dp link: 'pod' when the mesh has one) through the e5m2
      error-feedback all-reduce (`grad_compress`); the other dp axes
      reduce in f32 first.

  policy.dist.wire_zero_gather = "full" | "fp8"
      "fp8" moves ZeRO-1's weight all-gather as e4m3 payloads with one
      scale a leaf, shared over the 'data' ranks (`gather_params`), in the
      compressing step alone: the reference's "full" step never calls it.

The plan owns the specs (`param_specs`, `master_specs` / `grad_specs`,
`train_state_specs`, `batch_specs`; `distributed.sharding`'s rules) and
ZeRO-1's shard bookkeeping: `zero_dims(params)` fixes, from the whole
parameter tree, the dim each master leaf is split along over 'data' (the
'data' entry of its master spec) and keeps it for the step and the loop;
`shard_state` / `unshard_state` move a MixedPrecisionState between the
whole layout and this rank's shards (master weights and Adam moments;
the scalars stay whole); `shard` / `gather` do one tree. A rank's shard
of a leaf is chunk r of N along its dim, r its rank in the 'data' group.

Tensor parallelism (`tp_dims(params)`, `tp_rank`, `tp_group()`): the
'model' entry of each leaf's param spec fixes the dim it is split along,
and rank r of the 'model' group holds chunk r of m. `shard_state` takes a
leaf's 'model' chunk, then of that its 'data' chunk (ZeRO-1 picks its dim
on the whole shape among the dims TP leaves whole, the reference's
`zero1_specs`); `unshard_state` gathers over 'data', then 'model'. The
training step runs TP for the attention-plus-dense-FFN decoders (the
layers' column- and row-parallel sites, head-sharded attention, the
vocab-parallel embedding, head and cross-entropy: `distributed.
tensor_parallel`) and refuses the rest under a TP plan, naming ROADMAP.md
and slice 10d (`train.step._refuse_tp`); `build` refuses the fp8 wire and
the fp8 gather with an active model dim, as the reference's does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.fp8_formats import E4M3, E5M2
from repro_torch.core.precision_policy import DistConfig
from repro_torch.core.quantize import quantize_rne
from repro_torch.distributed import comm, sharding
from repro_torch.distributed.grad_compress import (
    make_compressed_dp_allreduce, make_full_dp_allreduce, wire_bytes_model)
from repro_torch.models.convert import shard_leaves, unshard_leaves
from repro_torch.optim.optimizers import tmap

# e4m3's shared gather scale is floored here, as the wire's scales are.
_SCALE_FLOOR = 1e-30


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """Batch-dim parallelism over the given mesh dims (outermost first)."""
    axes: Tuple[str, ...] = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class ZeRO1Sharded:
    """ZeRO stage 1: master weights and optimizer moments sharded over one
    data-parallel dim."""
    axis: str = "data"


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """Megatron tensor parallelism over one mesh dim."""
    axis: str = "model"


def mesh_sizes(mesh) -> Dict[str, int]:
    """{dim name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """The composed plan for one mesh: which strategies are active, the
    process groups they reduce over, and the wire-format collectives."""
    mesh: Any
    dist: DistConfig
    dp: Optional[DataParallel]
    zero1: Optional[ZeRO1Sharded]
    tp: Optional[TensorParallel]
    _groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)
    _layout: Dict[str, Any] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    # -- construction --------------------------------------------------------
    @classmethod
    def build(cls, mesh, dist: DistConfig = DistConfig()) -> "ParallelPlan":
        names = set(mesh.mesh_dim_names)
        sizes = mesh_sizes(mesh)
        dp = DataParallel(tuple(a for a in DataParallel.axes
                                if a in names)) if dist.dp else None
        if dp is not None and not dp.axes:
            dp = None
        zero1 = ZeRO1Sharded() if (dist.zero1 and sizes.get("data", 1) > 1) \
            else None
        tp = TensorParallel() if (dist.tp and sizes.get("model", 1) > 1) \
            else None
        plan = cls(mesh=mesh, dist=dist, dp=dp, zero1=zero1, tp=tp)
        if (dist.wire == "fp8_ef" or dist.wire_zero_gather == "fp8") \
                and plan.tp_size > 1:
            raise NotImplementedError(
                "fp8 wire formats run over the dp dims alone and are refused "
                "with an active model dim (as in the reference): use a pure "
                "data-parallel mesh or policy.dist.wire='full'")
        if dist.wire_axis is not None and dist.wire_axis not in names:
            raise ValueError(f"wire_axis {dist.wire_axis!r} not in mesh "
                             f"axes {sorted(names)}")
        return plan

    # -- axis bookkeeping ----------------------------------------------------
    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return self.dp.axes if self.dp is not None else ()

    @property
    def dp_size(self) -> int:
        sizes = mesh_sizes(self.mesh)
        n = 1
        for a in self.dp_axes:
            n *= sizes[a]
        return n

    @property
    def model_size(self) -> int:
        return mesh_sizes(self.mesh).get("model", 1)

    @property
    def tp_size(self) -> int:
        """Model-dim size when TensorParallel is active, else 1."""
        return self.model_size if self.tp is not None else 1

    @property
    def wire_axis(self) -> Optional[str]:
        """The dp dim the (possibly compressed) reduction runs over: 'pod'
        when present, else 'data'; None without data parallelism."""
        if not self.dp_axes:
            return None
        if self.dist.wire_axis is not None:
            return self.dist.wire_axis
        return self.dp_axes[0]

    @property
    def inner_dp_axes(self) -> Tuple[str, ...]:
        """dp dims reduced in f32 before the wire hop."""
        return tuple(a for a in self.dp_axes if a != self.wire_axis)

    @property
    def n_wire(self) -> int:
        w = self.wire_axis
        return mesh_sizes(self.mesh)[w] if w is not None else 1

    @property
    def compresses(self) -> bool:
        """Whether the DP reduction goes through the fp8_ef path (the knob
        and more than one rank on the wire dim)."""
        return self.dist.wire == "fp8_ef" and self.n_wire > 1 \
            and self.dp is not None

    # -- process groups -------------------------------------------------------
    def group(self, axes) -> Any:
        """The process group of this rank over mesh dims `axes` (one name
        or a tuple). A single dim's group is the mesh's; several dims get
        a group of their own, made on first use: every rank of the mesh
        must ask for it, in the same order (torch's new_group)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        if axes not in self._groups:
            names = list(self.mesh.mesh_dim_names)
            keep = [names.index(a) for a in axes]
            rest = [i for i in range(len(names)) if i not in keep]
            sizes = mesh_sizes(self.mesh)
            grid = self.mesh.mesh.permute(*rest, *keep).reshape(
                -1, math.prod(sizes[a] for a in axes))
            me = dist.get_rank()
            for ranks in grid.tolist():
                g = dist.new_group(ranks)
                if me in ranks:
                    self._groups[axes] = g
        return self._groups[axes]

    def dp_group(self):
        return self.group(self.dp_axes)

    @property
    def dp_rank(self) -> int:
        """This rank's index over the dp dims, outermost first: the slice
        of the global batch it takes (the reference's batch layout)."""
        coord = dict(zip(self.mesh.mesh_dim_names,
                         self.mesh.get_coordinate()))
        sizes = mesh_sizes(self.mesh)
        idx = 0
        for a in self.dp_axes:
            idx = idx * sizes[a] + coord[a]
        return idx

    @property
    def wire_rank(self) -> int:
        """This rank's coordinate on the wire dim (its slot of the stacked
        residual)."""
        coord = dict(zip(self.mesh.mesh_dim_names,
                         self.mesh.get_coordinate()))
        return coord[self.wire_axis]

    # -- collectives ---------------------------------------------------------
    def dp_allreduce(self, *, wire: Optional[str] = None) -> Callable:
        """The DP reduction over the wire dim: allreduce(grads, error) ->
        (reduced, new_error), on each rank its own gradient and residual."""
        w = self.wire_axis
        if w is None:
            raise ValueError("no data-parallel axes: nothing to reduce")
        wire = self.dist.wire if wire is None else wire
        if wire == "fp8_ef":
            return make_compressed_dp_allreduce(self.group(w), fmt=E5M2)
        return make_full_dp_allreduce(self.group(w))

    # -- specs ---------------------------------------------------------------
    def param_specs(self, params: Any, path_of=lambda p: p) -> Any:
        if self.tp is None:
            return sharding.replicated(params)
        return sharding.param_specs(params, mesh_sizes(self.mesh),
                                    path_of=path_of)

    def master_specs(self, params: Any, pspecs: Any = None) -> Any:
        """TP specs plus the ZeRO-1 'data' shard on the largest free dim."""
        if pspecs is None:
            pspecs = self.param_specs(params)
        if self.zero1 is None:
            return pspecs
        return sharding.zero1_specs(params, pspecs, mesh_sizes(self.mesh))

    # Gradients share the master layout (ZeRO-sharded).
    grad_specs = master_specs

    def train_state_specs(self, state: Any) -> Any:
        """Spec tree of a MixedPrecisionState (the master and the moments
        in the ZeRO-1 layout, the scalars replicated)."""
        from repro_torch.core.loss_scale import LossScaleState
        from repro_torch.core.master_weights import MixedPrecisionState
        mspecs = self.master_specs(state.master)
        opt = {k: (mspecs if k in ("mu", "nu") else ())
               for k in state.opt_state}
        return MixedPrecisionState(master=mspecs, opt_state=opt,
                                   loss_scale=LossScaleState((), (), (), ()))

    def batch_specs(self, batch: Any) -> Any:
        if self.dp is None:
            return sharding.replicated(batch)
        return sharding.batch_specs(batch, mesh_sizes(self.mesh),
                                    batch_axes=self.dp_axes)

    # -- tensor-parallel layout -----------------------------------------------
    def tp_group(self):
        return self.group(self.tp.axis)

    @property
    def tp_rank(self) -> int:
        """This rank's index in its 'model' group (0 without TP)."""
        return dist.get_rank(self.tp_group()) if self.tp is not None else 0

    def tp_dims(self, params: Any = None) -> Any:
        """The 'model' dim of each parameter leaf (its `param_specs` entry,
        or None: replicated), from the whole tree `params`, kept for later
        calls without it; None without TP. Rank r holds chunk r of m."""
        if self.tp is None:
            return None
        if params is not None:
            self._layout["tp_dims"] = tmap(
                lambda s: sharding.dim_of(s, self.tp.axis),
                self.param_specs(params))
        if "tp_dims" not in self._layout:
            raise ValueError("the plan has no tensor-parallel layout yet: "
                             "call plan.shard_state(state) (or plan."
                             "tp_dims(params)) with the whole tree first")
        return self._layout["tp_dims"]

    # -- ZeRO-1 shard bookkeeping ---------------------------------------------
    def zero_group(self):
        return self.group(self.zero1.axis)

    @property
    def zero_size(self) -> int:
        return mesh_sizes(self.mesh)[self.zero1.axis] if self.zero1 else 1

    @property
    def zero_rank(self) -> int:
        return dist.get_rank(self.zero_group()) if self.zero1 else 0

    def zero_dims(self, params: Any = None) -> Any:
        """The ZeRO dim of each master leaf (its master spec's 'data'
        entry, or None), from the whole tree `params` (tensors or shapes),
        kept for later calls without `params`; None without ZeRO-1."""
        if self.zero1 is None:
            return None
        if params is not None:
            specs = self.master_specs(params)
            self._layout["dims"] = tmap(
                lambda s: sharding.dim_of(s, self.zero1.axis), specs)
        if "dims" not in self._layout:
            raise ValueError("the plan has no ZeRO layout yet: call "
                             "plan.zero_dims(params) or plan.shard_state("
                             "state) with the whole tree first")
        return self._layout["dims"]

    def shard(self, tree: Any) -> Any:
        """This rank's shards of a whole tree shaped like the master: its
        'model' chunk (TP), then of that its 'data' chunk (ZeRO-1)."""
        if self.tp is not None:
            tree = shard_leaves(tree, self.tp_dims(), self.tp_rank,
                                self.tp_size)
        if self.zero1 is not None:
            tree = shard_leaves(tree, self.zero_dims(), self.zero_rank,
                                self.zero_size)
        return tree

    def gather(self, tree: Any, *, to_host: bool = False) -> Any:
        """The whole tree of the ranks' shards (an all-gather a sharded
        leaf over 'data', then over 'model', every rank taking part; any
        dtype). `to_host`: each whole leaf moves to host memory as soon as
        it is gathered (the device never holds more than one whole
        leaf)."""
        def one(x, zd, td):
            if zd is not None:
                x = unshard_leaves(
                    list(comm.all_gather(x, self.zero_group())), zd)
            if td is not None:
                x = unshard_leaves(
                    list(comm.all_gather(x, self.tp_group())), td)
            return x.cpu() if to_host else x
        return tmap(one, tree, *self.layout_dims(tree))

    def layout_dims(self, tree: Any):
        """(ZeRO dims, TP dims) of a tree shaped like the master, each a
        tree of Nones where its strategy is off."""
        nones = tmap(lambda _: None, tree)
        return (self.zero_dims() if self.zero1 is not None else nones,
                self.tp_dims() if self.tp is not None else nones)

    def shard_state(self, state):
        """A whole MixedPrecisionState -> this rank's (master, mu, nu
        sharded over 'model' and 'data'; fixes the layouts from the whole
        master)."""
        self.tp_dims(state.master)
        self.zero_dims(state.master)
        return self._map_state(state, self.shard)

    def unshard_state(self, state, *, to_host: bool = False):
        """This rank's sharded MixedPrecisionState -> the whole one, on
        every rank (`to_host`: the master and moments in host memory)."""
        return self._map_state(
            state, lambda t: self.gather(t, to_host=to_host))

    def _map_state(self, state, fn):
        from repro_torch.core.master_weights import MixedPrecisionState
        opt = {k: (fn(v) if k in ("mu", "nu") else v)
               for k, v in state.opt_state.items()}
        return MixedPrecisionState(master=fn(state.master), opt_state=opt,
                                   loss_scale=state.loss_scale)

    def full_shapes(self, shards: Any) -> Any:
        """The whole shapes of a tree of this rank's shards."""
        def one(x, zd, td):
            shape = list(x.shape)
            if zd is not None:
                shape[zd] *= self.zero_size
            if td is not None:
                shape[td] *= self.tp_size
            return tuple(shape)
        return tmap(one, shards, *self.layout_dims(shards))

    def gather_params(self, params: Any, *, fp8: bool) -> Any:
        """ZeRO-1's weight all-gather of the compute params (this rank's
        shards in the compute dtype) -> the whole leaves. `fp8` (the
        compressing step under wire_zero_gather='fp8', as the reference
        calls `gather_params` from its wire steps alone) moves each
        sharded leaf as e4m3 payloads in the reference's arithmetic: x the
        shard in f32, scale = the MAX of |x| over 'data' / 448 floored at
        1e-30 (one MAX all-reduce of every leaf's amax), q = RNE_e4m3(x /
        scale) saturating, the payloads gathered along the leaf's dim and
        decoded as (q * scale) in the compute dtype. Otherwise the shards
        travel as they are (bf16 bits)."""
        grp = self.zero_group()
        dims = self.zero_dims()
        if not fp8:
            return tmap(lambda x, d: x if d is None
                        else comm.all_gather_dim(x, d, grp), params, dims)
        sharded = [x for x, d in zip(_leaves(params), _leaves(dims))
                   if d is not None]
        scales = iter(e4m3_gather_scales(sharded, grp))

        def leaf(x, d):
            if d is None:
                return x
            scale = next(scales)
            q = quantize_rne(x.float() / scale, E4M3, saturate=True)
            g = comm.all_gather_dim(q.view(torch.uint8), d, grp)
            return (g.view(E4M3.dtype).float() * scale).to(x.dtype)
        return tmap(leaf, params, dims)

    # -- error-feedback wire state -------------------------------------------
    def init_wire_state(self, params: Any) -> Any:
        """This rank's error-feedback residual: an f32 zero tensor for each
        master leaf at its whole shape (under ZeRO-1 `params` may be this
        rank's shards), on its device. The reference's stacked residual
        holds the n_wire ranks' on a leading axis (`models.convert.
        stack_wire_error`); the checkpoint keeps that layout."""
        shapes = self.full_shapes(params)
        return tmap(lambda p, s: torch.zeros(s, dtype=torch.float32,
                                             device=p.device),
                    params, shapes)

    # -- accounting / description --------------------------------------------
    def wire_bytes(self, params: Any) -> dict:
        """Modeled per-step wire bytes of the DP gradient reduction over the
        wire dim (the comm/* metrics)."""
        m = wire_bytes_model(params, self.n_wire)
        active = m["bytes_fp8_ef"] if self.compresses \
            else m["bytes_full_bf16"]
        m["wire"] = self.dist.wire if self.compresses else "full"
        m["bytes_per_step"] = active
        return m

    def describe(self) -> dict:
        """JSON-able summary for launch meta and logger sidecars."""
        return {
            "dp_axes": list(self.dp_axes),
            "dp_size": self.dp_size,
            "zero1_axis": self.zero1.axis if self.zero1 else None,
            "tp_axis": self.tp.axis if self.tp else None,
            "tp_size": self.model_size if self.tp else 1,
            "wire": self.dist.wire,
            "wire_axis": self.wire_axis,
            "wire_zero_gather": self.dist.wire_zero_gather,
            "compresses": self.compresses,
        }


def e4m3_gather_scales(shards, group):
    """Each leaf's shared e4m3 gather scale: the MAX over `group` of the
    shard's amax (one all-reduce of the vector), / 448, floored."""
    if not shards:
        return []
    amax = torch.stack([x.float().abs().max() for x in shards])
    amax = comm.all_reduce(amax, "max", group)
    return list(torch.clamp_min(amax / E4M3.max_normal, _SCALE_FLOOR))


def _leaves(tree):
    """The leaves of nested dicts, in `tmap`'s order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
