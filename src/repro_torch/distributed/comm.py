"""The transport every collective of the data-parallel path goes through.

Four operations on a process group: an all-to-all and an all-gather of
1-byte payloads (fp8 tensors travel as their `uint8` views: gloo refuses
`torch.float8_*` tensors), and SUM / MAX all-reduces of f32 tensors. A
group's backend is the caller's choice and this layer never switches it:

 * NCCL takes device tensors as they are.
 * gloo has no all-to-all for CUDA tensors, so with a gloo group a CUDA
   payload is copied to a host buffer, exchanged, and copied back. The
   arithmetic around the collective stays on the device; only the
   exchange crosses the host, and every byte of it is counted.

Counters (`counts()`, `reset_counts()`), per process:
 * sent_bytes — the bytes a rank sends, by kind ("payload" for the
   1-byte legs, "reduce" for the f32 all-reduces, "gather" for f32
   all-gathers): an all-to-all of n chunks of c bytes sends (n - 1) c, an
   all-gather of c bytes (n - 1) c, an all-reduce of B bytes the ring's
   2 (n - 1) / n B.
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
    if _staged(group, t):
        _count("staged", t.numel() * t.element_size())
        return t.cpu()
    return t


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
    recv = torch.empty_like(send)
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
    out = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(out, send, group=group)
    _count("sent/payload", (n - 1) * chunk.numel())
    _count("calls/all_gather", 1)
    return _from_wire(group, torch.stack(out), chunk)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Any tensor -> (n, *x.shape), row i from rank i."""
    n = group_size(group)
    send = _to_wire(group, x.contiguous())
    out: List[torch.Tensor] = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(out, send, group=group)
    _count("sent/gather", (n - 1) * x.numel() * x.element_size())
    _count("calls/all_gather", 1)
    return _from_wire(group, torch.stack(out), x)


def all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """SUM or MAX of `x` over `group`; returns a new tensor on x's
    device (x itself is left as it was)."""
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    n = group_size(group)
    buf = _to_wire(group, x.contiguous())
    if buf is x:
        buf = x.clone()
    dist.all_reduce(buf, op=rop, group=group)
    _count("sent/reduce", 2.0 * (n - 1) / n * x.numel() * x.element_size())
    _count("calls/all_reduce", 1)
    return _from_wire(group, buf, x)
