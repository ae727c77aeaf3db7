"""Carry the reference's parameters into the port.

`from_jax_params(tree, cfg, device)` takes the tree `repro.models.
transformer.init_lm` returns, as nested dicts of numpy arrays (the caller
converts with `jax.tree_util.tree_map(np.asarray, params)`), and returns
the port's parameter dict on `device`. Scanned stacks (`stack_{p}`, with a
leading group axis) are split into the unscanned `layer_{i}` layout the
port runs, in the decoder and, for an encoder-decoder, in the encoder
(whose one-kind stack holds `n_encoder_layers` groups); the unrolled
remainder layers `rem_{i}` of a block pattern that does not divide the
depth become `layer_{n_groups * len(pattern) + i}`; `layer_{i}` trees
pass through (an RG-LRU layer's `rglru` leaves among them), as do
`enc_norm` and each decoder layer's
`cross_norm` / `cross_attn`, and a mixture-of-experts layer's `moe`
subtree (`router` (D, E) and the expert stacks `w_gate` / `w_up` (E, D, F)
and `w_down` (E, F, D), their shapes checked against the config). Nothing
is padded: the embedding already has `padded_vocab_size` rows.

The data-parallel wire's residual has two layouts, the reference's one
tree stacked over the wire's ranks and the port's one tree a rank:
`stack_wire_error`, `unstack_wire_error` and `wire_error_from_jax` convert
(the checkpoint stores the stacked one). ZeRO-1's master weights and
moments have two as well, the whole tree (the reference's layout, which
the checkpoint stores) and one rank's shards: `shard_leaves` and
`unshard_leaves` convert, given each leaf's ZeRO dim, and tensor
parallelism's shards over 'model' likewise, given its TP dim. `jax_path` maps a
parameter path of the port to the reference's (the sharding rules match
the reference's paths).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def _split_stacks(stack: Dict[str, Any], n_layers: int, n_kinds: int):
    """A stack's `stack_{p}` entries (n_layers // n_kinds groups each) and
    remainder `rem_{i}` entries as `layer_{i}` entries; other entries pass
    through."""
    out: Dict[str, Any] = {}
    n_groups = n_layers // n_kinds
    for key, sub in stack.items():
        if key.startswith("rem_"):
            out[f"layer_{n_groups * n_kinds + int(key[len('rem_'):])}"] = sub
            continue
        if not key.startswith("stack_"):
            out[key] = sub
            continue
        pos = int(key[len("stack_"):])

        def take(t, g):
            return {k: take(v, g) for k, v in t.items()} \
                if isinstance(t, dict) else np.asarray(t)[g]

        for g in range(n_groups):
            out[f"layer_{g * n_kinds + pos}"] = take(sub, g)
    # Layers in execution order.
    return dict(sorted(out.items(), key=lambda kv: int(kv[0][6:])
                       if kv[0].startswith("layer_") else -1))


def _check_moe(layers: Dict[str, Any], cfg: ModelConfig):
    """Each decoder layer's `moe` leaves have the config's shapes."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    want = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
            "w_down": (e, f, d)}
    for name, layer in layers.items():
        got = {k: np.shape(v) for k, v in layer.get("moe", {}).items()}
        if got != want:
            raise ValueError(f"decoder/{name}/moe has leaves {got}, the "
                             f"config wants {want}")


def from_jax_params(tree, cfg: ModelConfig, device=None):
    """The reference's init_lm tree (numpy leaves) -> the port's params."""
    cfg.check_ported()
    dev = resolve_device(device)
    tree = dict(tree)
    tree["decoder"] = _split_stacks(dict(tree["decoder"]), cfg.n_layers,
                                    len(cfg.pattern()))
    if cfg.is_encoder_decoder:
        tree["encoder"] = _split_stacks(dict(tree["encoder"]),
                                        cfg.n_encoder_layers, 1)
    if cfg.n_experts:
        _check_moe(tree["decoder"], cfg)
    emb = np.asarray(tree["embed"]["table"])
    if emb.shape != (cfg.padded_vocab_size, cfg.d_model):
        raise ValueError(f"embedding {emb.shape} does not match the config "
                         f"({cfg.padded_vocab_size}, {cfg.d_model})")
    return _to_torch(tree, dev)


# ---------------------------------------------------------------------------
# The error-feedback residual's two layouts. The reference holds the wire's
# N ranks' residuals in one tree, each leaf stacked on a leading (N,) axis
# (its "stacked contract"); each rank of the port holds its own residual,
# a tree of f32 tensors like the master weights.
# ---------------------------------------------------------------------------

def stack_wire_error(residuals):
    """[rank 0's residual, rank 1's, ...] -> one tree whose leaves carry
    the ranks on a leading axis (the reference's layout, which the
    checkpoint stores)."""
    first = residuals[0]
    if isinstance(first, dict):
        return {k: stack_wire_error([r[k] for r in residuals])
                for k in first}
    return torch.stack(list(residuals))


def unstack_wire_error(stacked, index: int):
    """Rank `index`'s residual out of the stacked layout (a view)."""
    if isinstance(stacked, dict):
        return {k: unstack_wire_error(v, index) for k, v in stacked.items()}
    return stacked[index]


def wire_error_from_jax(stacked, cfg: ModelConfig, device=None):
    """The reference's stacked residual (numpy leaves, its parameter tree's
    layout) -> the port's per-rank residuals, a list in rank order."""
    n = int(np.shape(next(_np_leaves(stacked)))[0])
    return [from_jax_params(_np_slice(stacked, i), cfg, device=device)
            for i in range(n)]


def _np_slice(tree, i):
    if isinstance(tree, dict):
        return {k: _np_slice(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _np_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _np_leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# A sharded state's two layouts, the whole tree and one rank's shards, for
# ZeRO-1 over 'data' and tensor parallelism over 'model' alike. `dims` is a
# tree like the state's, each leaf the dim the leaf is split along over the
# ranks (None: kept whole on every rank). The reference's params, as numpy
# through `from_jax_params`, are the whole tree.
# ---------------------------------------------------------------------------

def shard_leaves(tree, dims, index: int, n: int):
    """Rank `index`'s shards of a whole tree: chunk `index` of `n` equal
    chunks of each leaf along its dim (a contiguous copy); leaves without
    a dim are returned as they are."""
    if isinstance(tree, dict):
        return {k: shard_leaves(v, dims[k], index, n)
                for k, v in tree.items()}
    if dims is None:
        return tree
    return torch.chunk(tree, n, dim=dims)[index].contiguous()


def unshard_leaves(shards, dims):
    """[rank 0's shard tree, rank 1's, ...] -> the whole tree: each leaf's
    shards concatenated along its dim in rank order (a leaf without a dim
    is rank 0's)."""
    first = shards[0]
    if isinstance(first, dict):
        return {k: unshard_leaves([s[k] for s in shards], dims[k])
                for k in first}
    if dims is None:
        return first
    return torch.cat(list(shards), dim=dims)


def jax_path(path: str, cfg: ModelConfig) -> str:
    """The reference's path of a port parameter path: a decoder (or
    encoder) `layer_{i}` is the reference's `stack_{i mod kinds}` under
    scanned layers, `layer_{i}` unscanned, or `rem_{j}` past the whole
    groups (the inverse of `from_jax_params`' split)."""
    parts = path.split("/")
    if len(parts) > 1 and parts[0] in ("decoder", "encoder") \
            and parts[1].startswith("layer_"):
        i = int(parts[1][len("layer_"):])
        n, kinds = ((cfg.n_layers, len(cfg.pattern()))
                    if parts[0] == "decoder" else (cfg.n_encoder_layers, 1))
        groups = n // kinds
        if i >= groups * kinds:
            parts[1] = f"rem_{i - groups * kinds}"
        elif cfg.scan_layers and groups > 1:
            parts[1] = f"stack_{i % kinds}"
    return "/".join(parts)
