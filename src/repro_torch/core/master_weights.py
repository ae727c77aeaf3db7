"""FP16 master weights with FP32 update math — the paper's Fig. 1b
(counterpart of `repro.core.master_weights`).

Per step: overflow probe on the raw (loss-scaled) gradients, unscale in
f32, up-convert the fp16 master to f32, run the inner optimizer in f32,
keep the old master and optimizer state where the gradients overflowed,
store the master back in fp16, and advance the loss scaler. Everything
stays on the device; the overflow flag is a 0-d bool tensor.

Memory: the fused leaf-wise path (`accum_names` + `leaf_update` given, as
`train.step.make_optimizer_for` builds it) updates the master weights and
the optimizer accumulators IN PLACE, one leaf at a time, so the only f32
temporaries are those of one leaf. The state object it returns holds the
same tensors as the one it was given; a caller that needs the old state
must copy it first. The tree-level path (no leaf update) is functional.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.loss_scale import LossScaler, LossScaleState, all_finite
from repro_torch.core.precision_policy import dtype_of
from repro_torch.optim.optimizers import tmap


@dataclasses.dataclass
class MixedPrecisionState:
    master: Any          # dict of tensors at master_dtype (paper: fp16)
    opt_state: Any       # inner optimizer state (f32 accumulators, count)
    loss_scale: LossScaleState


@dataclasses.dataclass(frozen=True)
class MixedPrecisionOptimizer:
    inner_init: Callable[[Any], Any]
    inner_update: Callable[[Any, Any, Any], Tuple[Any, Any]]
    scaler: LossScaler
    master_dtype: str = "float16"
    update_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    accum_names: Tuple[str, ...] = ()
    leaf_update: Optional[Callable] = None

    def init(self, params) -> MixedPrecisionState:
        mdt = dtype_of(self.master_dtype)
        master = tmap(lambda p: p.detach().to(mdt).clone(), params)
        opt_state = self.inner_init(
            tmap(lambda p: p.detach().to(torch.float32), params))
        dev = next(iter(_leaves(master))).device
        return MixedPrecisionState(master=master, opt_state=opt_state,
                                   loss_scale=self.scaler.init(device=dev))

    def compute_params(self, state: MixedPrecisionState):
        """Model-facing params: the master cast to the compute dtype."""
        cdt = dtype_of(self.compute_dtype)
        return tmap(lambda p: p.to(cdt), state.master)

    def apply_gradients(self, state: MixedPrecisionState, grads,
                        finite: Optional[torch.Tensor] = None
                        ) -> Tuple[MixedPrecisionState, dict]:
        """Returns (new state, metrics) with 0-d device tensors in metrics:
        grads_finite, loss_scale (after the update), overflow_count.
        `finite`: the overflow flag when the caller has it (under ZeRO-1,
        that of the whole gradient, combined over the ranks whose shards
        `grads` and the state are); otherwise `all_finite(grads)`. The
        update is element-wise, so on a shard it is the shard of the
        whole update."""
        if finite is None:
            finite = all_finite(grads)
        if self.leaf_update is not None:
            return self._apply_gradients_fused(state, grads, finite)
        udt = dtype_of(self.update_dtype)
        mdt = dtype_of(self.master_dtype)
        grads32 = self.scaler.unscale(state.loss_scale, grads)
        master32 = tmap(lambda p: p.to(udt), state.master)
        updates, new_opt = self.inner_update(grads32, state.opt_state,
                                             master32)
        new_master32 = tmap(lambda p, u: p + u, master32, updates)
        new_master32 = tmap(lambda n, o: torch.where(finite, n, o),
                            new_master32, master32)
        new_opt = tmap(lambda n, o: torch.where(finite, n, o), new_opt,
                       state.opt_state)
        new_master = tmap(lambda p: p.to(mdt), new_master32)
        return self._finish(state, new_master, new_opt, finite)

    def _finish(self, state, new_master, new_opt, finite):
        new_ls = self.scaler.update(state.loss_scale, finite)
        metrics = {"grads_finite": finite, "loss_scale": new_ls.scale,
                   "overflow_count": new_ls.overflow_count}
        return MixedPrecisionState(master=new_master, opt_state=new_opt,
                                   loss_scale=new_ls), metrics

    def _apply_gradients_fused(self, state: MixedPrecisionState, grads,
                               finite: torch.Tensor
                               ) -> Tuple[MixedPrecisionState, dict]:
        """Leaf by leaf, in place (module docstring)."""
        udt = dtype_of(self.update_dtype)
        names = self.accum_names
        inv = self.scaler.inverse(state.loss_scale)
        old_count = state.opt_state["count"]
        count = torch.where(finite, old_count + 1, old_count)

        def leaf_fn(g, m, *accs):
            g32 = g.to(udt) * inv
            p32 = m.to(udt)
            upd, new_acc = self.leaf_update(g32, dict(zip(names, accs)),
                                            count, p32)
            m.copy_(torch.where(finite, p32 + upd, p32))
            for n, a in zip(names, accs):
                a.copy_(torch.where(finite, new_acc[n], a))
            return m

        with torch.no_grad():
            tmap(leaf_fn, grads, state.master,
                 *(state.opt_state[n] for n in names))
        new_opt = dict(state.opt_state)
        new_opt["count"] = count
        return self._finish(state, state.master, new_opt, finite)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
