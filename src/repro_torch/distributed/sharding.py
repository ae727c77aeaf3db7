"""Sharding rules: parameter, optimizer and batch specs for a mesh
(counterpart of `repro.distributed.sharding`), as pure functions of paths
and shapes.

A spec is a tuple with one entry per dim of a leaf: the name of the mesh
dim it is split over, or None. Megatron-style tensor parallelism over the
'model' dim:
  * column-parallel: qkv / up / gate projections shard their output dim;
  * row-parallel: out / down projections shard their input dim;
  * vocab-parallel embedding (and head);
  * expert-parallel mixture-of-experts: the expert dim over 'model'.
Data parallelism over ('pod', 'data') on the batch dim; ZeRO-1 shards the
master weights and the optimizer moments over 'data' on the largest free
dim. Every rule checks divisibility against the mesh's sizes and falls
back to replication where a dim does not divide.

`sizes` is {mesh dim name: size} (`strategy.mesh_sizes(mesh)` of a
DeviceMesh). A tree is nested dicts whose leaves have a `.shape` (tensors,
numpy arrays) or are shape tuples. The rules match the reference's
parameter paths: `param_specs` takes `path_of`, which maps a leaf's path
in the tree to the reference's (`models.convert.jax_path` for the port's
parameter tree); the rules look only at leaf and module names, so a
port path and its reference path take the same rule, dims counted from
the end.

The reference's `constrain`, `manual_axes` and `shard_map_compat` are its
partitioner's plumbing (sharding constraints on activations, shard_map
across JAX versions). They have no counterpart: each rank of the port
holds its own tensors and calls its collectives itself.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Tuple

Spec = Tuple[Optional[str], ...]

# (regex on the parameter path, candidate dims for the 'model' dim counted
# from the end of the shape; the first that divides wins; None: replicate).
_RULES = [
    (r"embed/table", (-2, -1)),    # (vocab, d): vocab-parallel, else d
    (r"embed/head", (-1, -2)),     # (d, vocab)
    (r"moe/router", None),         # replicated (f32, precision-critical)
    (r"moe/w_(gate|up|down)", (-3,)),  # (E, d, f): expert-parallel
    (r"(wq|wk|wv|up|gate|w_up|w_gate|wx|wg|wa|wi|w_zifo|w_if)$", (-1,)),
    (r"(wo|down|w_down)$", (-2,)),
    (r"(bq|bk|bv)$", (-1,)),       # column-parallel bias
    (r"(scale|bias|lam|conv|r_zifo|norm)", None),
]


def _shape(x) -> Tuple[int, ...]:
    return tuple(int(s) for s in (x.shape if hasattr(x, "shape") else x))


def _is_leaf(x) -> bool:
    return not isinstance(x, dict)


def _tmap_path(fn: Callable, tree, *rest, prefix: str = ""):
    """fn(path, leaf, *rest leaves) over nested dicts; paths join keys with
    '/' (the reference's `_path_str`)."""
    if _is_leaf(tree):
        return fn(prefix, tree, *rest)
    return {k: _tmap_path(fn, v, *(r[k] for r in rest),
                          prefix=f"{prefix}/{k}" if prefix else str(k))
            for k, v in tree.items()}


def _spec_for(path: str, shape: Tuple[int, ...], *, model_size: int,
              model_axis: str = "model") -> Spec:
    """The tensor-parallel spec of one leaf (the reference's rule table)."""
    ndim = len(shape)
    for pat, dims in _RULES:
        if re.search(pat, path):
            if dims is None or ndim == 0 or model_size <= 1:
                return ()
            for dim in dims:
                if -dim > ndim:
                    continue
                if shape[dim] % model_size == 0 and shape[dim] >= model_size:
                    spec = [None] * ndim
                    spec[ndim + dim] = model_axis
                    return tuple(spec)
            return ()               # graceful fallback: replicate
    return ()


def param_specs(params: Any, sizes: Dict[str, int], *,
                path_of: Callable[[str], str] = lambda p: p) -> Any:
    """The spec tree of `params` (tensors, arrays or shapes) under tensor
    parallelism on a mesh of `sizes`."""
    msize = sizes.get("model", 1)
    return _tmap_path(lambda path, x: _spec_for(path_of(path), _shape(x),
                                                model_size=msize), params)


def zero1_spec(shape: Tuple[int, ...], spec: Spec, dsize: int) -> Spec:
    """ZeRO-1's spec of one leaf: `spec` with 'data' on its largest
    unsharded dim that `dsize` divides (ties to the lower index); a 0-d
    leaf, or one where no such dim exists, keeps `spec`."""
    if dsize <= 1 or not shape:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if entries[i] is None and shape[i] % dsize == 0 \
                and shape[i] >= dsize:
            entries[i] = "data"
            return tuple(entries)
    return spec


def zero1_specs(params: Any, pspecs: Any, sizes: Dict[str, int]) -> Any:
    """ZeRO-1: additionally shard the largest unsharded dim over 'data'."""
    dsize = sizes.get("data", 1)
    if dsize <= 1:
        return pspecs
    return _tmap_path(lambda _, x, s: zero1_spec(_shape(x), s, dsize),
                      params, pspecs)


def batch_specs(batch: Any, sizes: Dict[str, int], *,
                batch_axes=("pod", "data")) -> Any:
    """Input batch: dim 0 over the data-parallel dims, if it divides (an
    entry naming several dims is a tuple of them)."""
    axes = tuple(a for a in batch_axes if a in sizes)
    total = 1
    for a in axes:
        total *= sizes[a]

    def spec_one(_, x):
        shape = _shape(x)
        if shape and total > 1 and shape[0] % total == 0:
            return (axes if len(axes) > 1 else axes[0],) \
                + (None,) * (len(shape) - 1)
        return ()

    return _tmap_path(spec_one, batch)


def replicated(tree: Any) -> Any:
    return _tmap_path(lambda *_: (), tree)


def dim_of(spec: Spec, axis: str) -> Optional[int]:
    """The dim a spec splits over mesh dim `axis`, or None."""
    return spec.index(axis) if axis in spec else None
