"""The global batch of a data-parallel "full" step, as the layers see it.

The reference's `wire="full"` step is one program over the global batch.
The port runs it as one program a rank, on the rank's rows; three things
of that program are not functions of a rank's rows alone, and the layers
that compute them read the active `GlobalBatch` (`current()`), which the
training step enters around its loss and backward passes:

 * a weight gradient's class-G Q node quantizes the SUM of the ranks'
   gradients: `qlinear.qeinsum`'s backward sums each weight-operand
   gradient in f32 over `group` before its Q node (`sums_weight`), and
   the step does not sum those leaves again (`summed`);
 * a mixture-of-experts layer's aux losses are means over the global
   batch: `models.moe` returns the rank's contribution to each, so the
   step's sum over the ranks gives the global value (`n_ranks` scales a
   call's rows to the global count; the expert counts are summed over
   `group`);
 * the nll's denominator is the global mask count (the step's own).

Under tensor parallelism (a 'data' and a 'model' dim) the 'data' sum
composes with the 'model' sums unchanged: a rank's weight leaf is its
'model' shard, whose gradient is the same shard of the whole gradient, so
`group` (the rank's 'data' group, ranks of one 'model' coordinate) sums
that shard before its G node; the sums over 'model' (a row-parallel
forward, a column-parallel input gradient, `distributed.tensor_parallel`)
are of activations, within each 'data' rank's rows, and never of a weight
gradient.

A weight operand qualifies when it is a parameter leaf of the step, or a
function of one leaf alone (a cast, a view, a transpose, a layer's slice):
autograd's graph is walked from the operand through nodes with a single
input to the leaf's accumulator. A leaf whose gradient is summed in the
backward must take no other gradient path: the tied embedding table under
a quantized head would (the step refuses it).
"""
from __future__ import annotations

import contextlib
from typing import Iterable, Optional, Set

import torch

_ACTIVE: Optional["GlobalBatch"] = None


class GlobalBatch:
    def __init__(self, group, n_ranks: int, params: Iterable[torch.Tensor]):
        self.group = group
        self.n_ranks = n_ranks
        self._params = {id(p) for p in params}
        self.summed: Set[int] = set()   # ids of leaves summed in backward

    def sums_weight(self, w: torch.Tensor) -> bool:
        """Whether `w`'s gradient is summed over the ranks in the backward
        (a parameter leaf or a function of one; module docstring); records
        the leaf."""
        leaf = param_leaf(w)
        if leaf is None or id(leaf) not in self._params:
            return False
        self.summed.add(id(leaf))
        return True


def param_leaf(t: torch.Tensor) -> Optional[torch.Tensor]:
    """The leaf tensor `t` is a function of alone, or None."""
    node = t.grad_fn
    if node is None:
        return t if t.is_leaf and t.requires_grad else None
    while not hasattr(node, "variable"):
        nxt = [f for f, _ in node.next_functions if f is not None]
        if len(nxt) != 1:
            return None
        node = nxt[0]
    return node.variable


def current() -> Optional[GlobalBatch]:
    return _ACTIVE


@contextlib.contextmanager
def active(gb: Optional[GlobalBatch]):
    """Make `gb` the current global batch (None: none) for the block."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, gb
    try:
        yield gb
    finally:
        _ACTIVE = saved
