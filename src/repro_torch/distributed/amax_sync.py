"""Cross-replica amax synchronization for delayed scaling (counterpart of
`repro.distributed.amax_sync`).

Under data parallelism each replica observes the amaxes of its own shard
of the batch; the scales must stay identical across replicas, or the
quantized networks (and their checkpointed ScaleStates) drift apart. The
sync is ONE element-wise MAX all-reduce of the dense (n_sites,)
observation vector a step, not one collective per site, applied by
`DelayedScaling.update(..., sync=make_amax_sync(group))`.

 * make_amax_sync(group) — the MAX over a process group (or over each of
   a sequence of groups in turn, as the reference's pmax over several
   axis names); None without a group.
 * host_amax_sync — the MAX over the default group; the identity on one
   process.

The vector is host numpy (the port's ScaleState lives on the host) or a
tensor; it crosses the group in the form its backend takes (a CUDA tensor
for NCCL, a host tensor for gloo) and comes back as it went in.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import comm


def _as_tensor(obs, group) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(obs, np.float32)) \
        if not isinstance(obs, torch.Tensor) else obs
    if t.device.type == "cpu" and dist.get_backend(group) == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def all_reduce_amax(obs, group: Union[object, Sequence[object]]):
    """Element-wise max of the observation vector over `group` (a process
    group, or a sequence of them reduced in turn)."""
    groups = tuple(group) if isinstance(group, (list, tuple)) else (group,)
    out = obs
    for g in groups:
        out = comm.all_reduce(_as_tensor(out, g), "max", g)
    if isinstance(obs, torch.Tensor):
        return out.to(obs.device)
    return out.cpu().numpy().astype(np.float32)


def make_amax_sync(group) -> Optional[Callable]:
    """Sync hook for DelayedScaling.update. No group -> None (a single
    replica, whose scales are consistent by construction)."""
    if group is None:
        return None
    return functools.partial(all_reduce_amax, group=group)


def host_amax_sync(obs):
    """Process-level max over the default group; the identity on a single
    process."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return obs
    return all_reduce_amax(obs, dist.group.WORLD)
