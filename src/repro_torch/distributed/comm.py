"""The transport every collective of the data-parallel path goes through.

On a process group: an all-to-all and an all-gather of 1-byte payloads
(fp8 tensors travel as their `uint8` views: gloo refuses `torch.float8_*`
tensors), SUM / MAX all-reduces of f32 tensors, and ZeRO-1's two
collectives: a SUM reduce-scatter of f32 tensors along a dim
(`reduce_scatter`) and an all-gather of shards along a dim
(`all_gather_dim`: bf16 weights, which travel as their bytes, or uint8
e4m3 payloads). A group's backend is the caller's choice and this
layer never switches it:

 * NCCL takes device tensors as they are.
 * gloo has no all-to-all for CUDA tensors, so with a gloo group a CUDA
   payload is copied to a pinned host buffer, exchanged into pinned
   buffers, and copied back; gathered rows are joined on the device. The
   arithmetic around the collective stays on the device; only the
   exchange crosses the host, and every byte of it is counted.
 * gloo has no reduce-scatter: there it is an all-to-all of the N chunks,
   then a sum of what arrives in rank order (NCCL: `reduce_scatter_tensor`).

Counters (`counts()`, `reset_counts()`), per process:
 * sent_bytes — the bytes a rank sends, by kind ("payload" for the
   1-byte legs, "reduce" for the f32 all-reduces and reduce-scatters,
   "gather" for f32 all-gathers, "zero_gather" for ZeRO-1's weight
   all-gather, "tp" for the tensor-parallel collectives over 'model'): an all-to-all of n chunks of c bytes sends (n - 1) c, an
   all-gather of c bytes (n - 1) c, an all-reduce of B bytes the ring's
   2 (n - 1) / n B, a reduce-scatter of B bytes (n - 1) / n B.
 * staged_bytes — bytes copied between the device and host buffers for a
   gloo exchange, both directions.
 * calls — collectives issued, by kind.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.distributed as dist

_COUNTS: Dict[str, float] = {}


def reset_counts():
    _COUNTS.clear()


def counts() -> Dict[str, Any]:
    """{"sent_bytes": {kind: n}, "staged_bytes": n, "calls": {kind: n}}."""
    def part(prefix):
        return {k[len(prefix):]: v for k, v in _COUNTS.items()
                if k.startswith(prefix)}
    return {"sent_bytes": part("sent/"),
            "staged_bytes": _COUNTS.get("staged", 0),
            "calls": part("calls/")}


def _count(key: str, n: float):
    _COUNTS[key] = _COUNTS.get(key, 0) + n


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def _staged(group, t: torch.Tensor) -> bool:
    """Whether `t` crosses the host for `group`'s exchange (gloo and a
    device tensor)."""
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _to_wire(group, t: torch.Tensor) -> torch.Tensor:
    """The tensor the exchange sends: a device tensor for a gloo group in
    a pinned host buffer (page-locked memory copies at the link's rate;
    torch caches the buffers), else `t`."""
    if _staged(group, t):
        _count("staged", t.numel() * t.element_size())
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t)
    return t


def _recv_like(send: torch.Tensor) -> torch.Tensor:
    """A receive buffer like `send` (pinned where `send` is)."""
    return torch.empty(send.shape, dtype=send.dtype, device=send.device,
                       pin_memory=send.device.type == "cpu"
                       and send.is_pinned())


def _from_wire(group, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if _staged(group, like):
        _count("staged", t.numel() * t.element_size())
        return t.to(like.device)
    return t


def all_to_all_bytes(chunks: torch.Tensor, group) -> torch.Tensor:
    """(n, c) uint8, row j for rank j of `group` -> (n, c) uint8, row i
    from rank i."""
    if chunks.dtype != torch.uint8:
        raise TypeError(f"payloads travel as uint8, got {chunks.dtype}")
    n = group_size(group)
    send = _to_wire(group, chunks.contiguous())
    recv = _recv_like(send)
    dist.all_to_all_single(recv, send, group=group)
    _count("sent/payload", (n - 1) * chunks.shape[1])
    _count("calls/all_to_all", 1)
    return _from_wire(group, recv, chunks)


def all_gather_bytes(chunk: torch.Tensor, group) -> torch.Tensor:
    """(c,) uint8 on every rank -> (n, c) uint8, row i from rank i."""
    if chunk.dtype != torch.uint8:
        raise TypeError(f"payloads travel as uint8, got {chunk.dtype}")
    n = group_size(group)
    send = _to_wire(group, chunk.contiguous())
    out = [_recv_like(send) for _ in range(n)]
    dist.all_gather(out, send, group=group)
    _count("sent/payload", (n - 1) * chunk.numel())
    _count("calls/all_gather", 1)
    return torch.stack([_from_wire(group, o, chunk) for o in out])


def all_gather(x: torch.Tensor, group, kind: str = "gather") -> torch.Tensor:
    """Any tensor -> (n, *x.shape), row i from rank i; its bytes count as
    `kind`."""
    n = group_size(group)
    send = _to_wire(group, x.contiguous())
    out: List[torch.Tensor] = [_recv_like(send) for _ in range(n)]
    dist.all_gather(out, send, group=group)
    _count(f"sent/{kind}", (n - 1) * x.numel() * x.element_size())
    _count("calls/all_gather", 1)
    return torch.stack([_from_wire(group, o, x) for o in out])


def all_reduce(x: torch.Tensor, op: str, group,
               kind: str = "reduce") -> torch.Tensor:
    """SUM or MAX of `x` over `group`; returns a new tensor on x's
    device (x itself is left as it was); its bytes count as `kind`."""
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    n = group_size(group)
    buf = _to_wire(group, x.contiguous())
    if buf is x:
        buf = x.clone()
    dist.all_reduce(buf, op=rop, group=group)
    _count(f"sent/{kind}", 2.0 * (n - 1) / n * x.numel() * x.element_size())
    _count("calls/all_reduce", 1)
    return _from_wire(group, buf, x)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """SUM over `group` of f32 `x`, of which this rank keeps chunk r (its
    group rank) of n equal chunks along `dim`. Under gloo an all-to-all of
    the chunks, then their sum in rank order; under NCCL
    `reduce_scatter_tensor`."""
    if x.dtype != torch.float32:
        raise TypeError(f"reduce_scatter sums f32 tensors, got {x.dtype}")
    n = group_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {n}")
    # (n, *chunk shape): chunk j, bound for rank j, in row j.
    chunks = torch.stack(torch.chunk(x, n, dim=dim))
    _count("sent/reduce", (n - 1) * chunks[0].numel() * 4)
    _count("calls/reduce_scatter", 1)
    if dist.get_backend(group) == "nccl":
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter_tensor(out, chunks, group=group)
        return out
    send = _to_wire(group, chunks)
    recv = _recv_like(send)
    dist.all_to_all_single(recv, send, group=group)
    recv = _from_wire(group, recv, chunks)
    acc = recv[0]
    for i in range(1, n):
        acc = acc + recv[i]
    return acc


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in group-rank order: a
    bf16 shard (moved as its bytes) or a uint8 payload. Its bytes count as
    "zero_gather"."""
    if x.dtype not in (torch.bfloat16, torch.uint8):
        raise TypeError(f"ZeRO gathers bf16 or uint8 shards, got {x.dtype}")
    n = group_size(group)
    wire = x.contiguous().reshape(-1).view(torch.uint8)
    send = _to_wire(group, wire)
    out = [_recv_like(send) for _ in range(n)]
    dist.all_gather(out, send, group=group)
    _count("sent/zero_gather", (n - 1) * x.numel() * x.element_size())
    _count("calls/all_gather", 1)
    return torch.cat([_from_wire(group, r, x).view(x.dtype).reshape(x.shape)
                      for r in out], dim=dim)
