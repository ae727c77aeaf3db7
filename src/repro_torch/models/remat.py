"""Activation recomputation (the reference's `jax.checkpoint` of a scanned
stack's layer body and of the chunked causal attention's q chunks).

`checkpointed(fn, gen, *args)` runs fn(gen, *args) under
`torch.utils.checkpoint` (non-reentrant): the region keeps only its inputs,
and the backward recomputes the rest when it first needs it. Three things
set the port apart from a plain checkpoint:

* SR bits. Every SR bit of a step comes from the step's explicit
  generator, which `torch.utils.checkpoint` does not restore. The
  recomputation draws from a clone of that generator set to the state it
  had when the region's forward began (`replay_generator`), so it
  reproduces the forward's bits, and the step's own generator is not
  advanced in the middle of the backward (every later draw of the
  backward keeps its bits).
* Scopes. Scale-site keys come from the scope stack, which has unwound by
  the time the recomputation runs inside backward(); it re-enters the
  scope path captured when the forward ran (`scaling.context.at_scope`).
* Records. The recomputation records the forward amaxes and health pairs
  a second time. `ScaleContext.record` / `record_health` max-combine and
  the values are the forward's own, so the records stand as they were;
  no use count is touched by a forward.
* Aux losses. A region may return them beside its output (a
  mixture-of-experts layer returns (h, aux)): they leave the region as
  outputs of its first forward, and their gradients flow back through
  it like the output's. The recomputation's outputs are discarded, so
  the aux losses are counted once.

The backward itself runs the nodes of the first forward (their saved
tensors replaced by the recomputed ones), so its own draws come from the
step's generator in the order they would without recomputation: a step
with recomputation equals the same step without it bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.scaling import context as scale_ctx


def replay_generator(gen: Optional[torch.Generator], state
                     ) -> Optional[torch.Generator]:
    """A fresh generator on `gen`'s device set to `state`: the source of
    the recomputation's draws."""
    if gen is None:
        return None
    out = torch.Generator(device=gen.device)
    out.set_state(state)
    return out


def checkpointed(fn, gen: Optional[torch.Generator], *args):
    """fn(gen, *args), recomputed in the backward. fn returns a tensor or
    a structure of them (a tuple, a dict); each output keeps its
    gradient. Without gradients it is a plain call (nothing to
    recompute)."""
    if not torch.is_grad_enabled():
        return fn(gen, *args)
    path = scale_ctx.scope_path()
    state = None if gen is None else gen.get_state()
    ran = []

    def region(*a):
        if not ran:
            ran.append(True)
            return fn(gen, *a)
        with scale_ctx.at_scope(path):
            return fn(replay_generator(gen, state), *a)

    return torch.utils.checkpoint.checkpoint(
        region, *args, use_reentrant=False, preserve_rng_state=False)
