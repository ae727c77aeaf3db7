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

The port runs data parallelism: ZeRO-1 and tensor parallelism are
recorded by `build` (so `describe()` is the reference's, field for field)
but the training step refuses them, as it refuses an fp8 ZeRO gather
(ROADMAP.md, queue 1, slice 10b).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.fp8_formats import E5M2
from repro_torch.core.precision_policy import DistConfig
from repro_torch.distributed.grad_compress import (
    make_compressed_dp_allreduce, make_full_dp_allreduce, wire_bytes_model)
from repro_torch.optim.optimizers import tmap


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

    # -- error-feedback wire state -------------------------------------------
    def init_wire_state(self, params: Any) -> Any:
        """This rank's error-feedback residual: an f32 zero tensor for each
        master leaf, on its device. The reference's stacked residual holds
        the n_wire ranks' on a leading axis (`models.convert.
        stack_wire_error`); the checkpoint keeps that layout."""
        return tmap(lambda p: torch.zeros(tuple(p.shape), dtype=torch.float32,
                                          device=p.device), params)

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
