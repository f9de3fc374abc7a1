"""Logical-axis sharding rules and the port's mesh (the port of
``repro/distributed/sharding.py``).

Every parameter, cache and input dimension carries a *logical* axis name
(`nn.layers.ParamSpec.axes`, `_CACHE_FIELD_AXES`); a rule table maps
logical names to mesh axes per execution mode, and `spec_for` drops a
mapping that does not divide the concrete dimension, so an odd size
degrades to replication, never to an invalid split:

  train (ZeRO-3 + TP):            serve (TP + EP, no ZeRO gather latency):
    batch  → (pod, data)            batch  → (pod, data) when divisible
    embed  → data   (FSDP shard)    embed  → —       (params replicated
    vocab  → model                  vocab  → model    across data; big-MoE
    heads/kv/mlp → model            heads/kv/mlp → model  experts → data)
    expert → —                      expert → data

The distributed EPS solver (`core/dist_solve.py`) shards the lane batch
and the subproblem pool over the 1-D ``solve`` axis (`SOLVE_RULES`).

`Mesh` is the port's counterpart of ``jax.sharding.Mesh``: an ndarray of
``torch.device`` entries with axis names.  Its entries may repeat: by
default (`make_mesh`) every shard sits on the one device asked for, the
torch counterpart of the reference's fake host devices.  A mesh of
``meta`` entries (`make_mesh(..., device="meta")`, the production mesh of
`launch/mesh.py`) only lays shapes out, for the dry-run; every entry
point that computes refuses ``meta`` (`core/device.resolve_device`).

The port has no ``NamedSharding``: `shardings_for_specs`,
`sharding_for_tree`, `batch_sharding` and `cache_shardings` give, per
leaf, a `Sharding`: the partition spec from `spec_for` and the leaf's
per-device `shard_shape`.  `shard_tree` places per-shard pieces of a
solver tree on their devices (``NamedSharding`` plus ``device_put``).
Training ranks shard their params by these specs over the host mesh
(`train/train_step.py`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device

Rules = Dict[str, Tuple[str, ...]]

TRAIN_RULES: Rules = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "embed": ("data",),          # ZeRO-3/FSDP shard of every weight matrix
    "heads": ("model",),
    "kv": ("model",),
    "mlp": ("model",),
    "expert": (),
    "layers": (),
    "seq": (),
    "kv_heads": (),
    "head_dim": (),
}

SERVE_RULES: Rules = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "embed": (),                 # replicated: no per-layer gather at decode
    "heads": ("model",),
    "kv": ("model",),
    "mlp": ("model",),
    "expert": ("data",),         # big-MoE weights: expert-parallel rows
    "layers": (),
    "seq": (),
    "kv_heads": ("model",),
    "head_dim": (),
}

# distributed EPS solver: the lane batch and the subproblem pool both
# shard over the 1-D `solve` axis; model tables and the scalar
# bound/flags are replicated
SOLVE_RULES: Rules = {
    "lanes": ("solve",),
    "pool": ("solve",),
}


def rules_for(mode: str) -> Rules:
    return TRAIN_RULES if mode == "train" else SERVE_RULES


class P(tuple):
    """A partition spec: one entry per dimension (None, a mesh axis name,
    or a tuple of names), trailing Nones dropped — ``P("solve")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)


class Mesh:
    """An ndarray of ``torch.device`` entries with one name per axis;
    ``shape`` maps each axis name to its size, as JAX's does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"mesh of rank {arr.ndim} given "
                             f"{len(axis_names)} axis names {axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.reshape(-1)))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"Mesh({self.shape}, devices={sorted(set(self._key()[2]))})"


def _mesh_device(device) -> torch.device:
    """``meta`` as is (a layout-only mesh), anything else through
    `resolve_device`."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices=None, device=None) -> Mesh:
    """A `Mesh` of ``shape`` over ``devices`` (the first prod(shape) of
    them, in order), or, without ``devices``, every entry ``device``
    (``None``: the card; it raises when there is none; ``meta``: a mesh
    that only lays shapes out)."""
    n = int(np.prod(shape))
    if devices is None:
        devs = [_mesh_device(device)] * n
    else:
        devs = [_mesh_device(d) for d in devices]
        if len(devs) < n:
            raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} "
                             f"devices, {len(devs)} given")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def spec_for(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
             rules: Rules, mesh: Mesh) -> P:
    """PartitionSpec with divisibility-checked axis assignment."""
    entries = []
    used = set()
    for dim, ax in zip(shape, axes):
        mesh_axes = tuple(a for a in rules.get(ax or "", ())
                          if a in mesh.shape and a not in used)
        size = int(np.prod([mesh.shape[a] for a in mesh_axes])) \
            if mesh_axes else 1
        if mesh_axes and dim % size == 0 and dim > 0:
            entries.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
            used.update(mesh_axes)
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


class Sharding(NamedTuple):
    """A leaf's layout over a mesh: its partition spec and the shape of
    the piece each device holds (``NamedSharding.shard_shape``)."""
    spec: P
    shard_shape: Tuple[int, ...]


def shard_shape(shape: Tuple[int, ...], spec: P, mesh: Mesh
                ) -> Tuple[int, ...]:
    """Each dimension divided by the product of its spec entry's mesh
    axes (`spec_for` only assigns axes that divide it)."""
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        out[i] //= int(np.prod([mesh.shape[a] for a in names]))
    return tuple(out)


def _sharding(shape, axes, rules: Rules, mesh: Mesh) -> Sharding:
    shape = tuple(int(d) for d in shape)
    spec = spec_for(shape, tuple(axes), rules, mesh)
    return Sharding(spec, shard_shape(shape, spec, mesh))


def shardings_for_specs(param_specs, rules: Rules, mesh: Mesh
                        ) -> Dict[str, Sharding]:
    """{path: Sharding} for a ParamSpec dict."""
    return {k: _sharding(s.shape, s.axes, rules, mesh)
            for k, s in param_specs.items()}


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(i, (int, str, type(None))) for i in x)


def sharding_for_tree(shapes_tree, axes_tree, rules: Rules, mesh: Mesh):
    """Shardings for a pair of trees of the same structure whose leaves
    are shape tuples and logical-axes tuples."""
    def walk(sh, ax):
        if _is_axes(sh):
            return _sharding(sh, ax, rules, mesh)
        if isinstance(sh, dict):
            return {k: walk(sh[k], ax[k]) for k in sh}
        if isinstance(sh, tuple) and hasattr(sh, "_fields"):
            return type(sh)(*(walk(a, b) for a, b in zip(sh, ax)))
        return type(sh)(walk(a, b) for a, b in zip(sh, ax))
    return walk(shapes_tree, axes_tree)


def leaf_shape(x) -> Tuple[int, ...]:
    """The shape of a tensor, or of a ``(shape, dtype)`` pair
    (`data.pipeline.input_shapes`)."""
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[1],
                                                           torch.dtype):
        return tuple(x[0])
    return tuple(x.shape)


def batch_sharding(batch_tree: Dict, rules: Rules, mesh: Mesh
                   ) -> Dict[str, Sharding]:
    """Inputs (a dict of tensors or ``(shape, dtype)`` pairs): dim 0 =
    batch, the rest unsharded."""
    out = {}
    for k, x in batch_tree.items():
        shape = leaf_shape(x)
        out[k] = _sharding(shape, ("batch",) + (None,) * (len(shape) - 1),
                           rules, mesh)
    return out


# -- cache shardings (field-name keyed; mirrors nn/model.py structures) -----

CACHE_RULES_SERVE: Rules = {
    **SERVE_RULES,
    # latent/feature dims shard over model (MLA latent attention and
    # head_dim contractions partial-sum + all-reduce under SPMD); when
    # kv_heads doesn't divide the model axis, head_dim picks it up.
    "embed_cache": ("model",),
    "head_dim": ("model",),
    "state": (),                 # ssm state dim
    "heads": ("model",),
}

# per cache field, axes WITHOUT the optional leading "layers" (added by
# rank).  `spec_for` drops any non-dividing assignment, so odd shapes
# degrade to replication, never to an invalid sharding.
_CACHE_FIELD_AXES = {
    "k": ("batch", "seq", "kv_heads", "head_dim"),
    "v": ("batch", "seq", "kv_heads", "head_dim"),
    "cross_k": ("batch", "seq", "kv_heads", "head_dim"),
    "cross_v": ("batch", "seq", "kv_heads", "head_dim"),
    "c_kv": ("batch", "seq", "embed_cache"),
    "k_rope": ("batch", "seq", "embed_cache"),
    "conv": ("batch", "seq", "mlp"),
    "length": (),
}
_H_SSM = ("batch", "heads", "head_dim", "state")   # mamba2 state
_H_LRU = ("batch", "mlp")                          # rg-lru hidden


def cache_shardings(cfg, caches, mesh: Mesh, rules: Optional[Rules] = None):
    """A `Sharding` per cache leaf (`nn.model.init_cache`'s structure:
    dicts and cache NamedTuples), keyed by the nearest enclosing field or
    dict key that names a cache field, as the reference's."""
    rules = rules or CACHE_RULES_SERVE

    def one(path, x):
        name = next((n for n in reversed(path)
                     if n in _CACHE_FIELD_AXES or n == "h"), None)
        shape = tuple(x.shape)
        if name == "h":
            ax = _H_SSM if len(shape) >= 4 else _H_LRU
        elif name is not None:
            ax = _CACHE_FIELD_AXES[name]
        else:
            ax = ()
        if len(shape) == len(ax) + 1:
            ax = ("layers",) + ax
        ax = ax[:len(shape)] if len(ax) >= len(shape) else \
            ax + (None,) * (len(shape) - len(ax))
        return _sharding(shape, ax, rules, mesh)

    return tree_map_with_path(one, caches)


def tree_map_with_path(fn: Callable, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over a tree of (named) tuples, lists and
    dicts; a path holds the dict keys, field names and list indices
    down to the leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, x, path + (f,))
                            for f, x in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, x, path + (i,))
                          for i, x in enumerate(tree))
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of a tree of (named) tuples, lists and
    dicts; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _lane_spec(x, rules: Rules, mesh: Mesh, axis: str = "lanes") -> P:
    return spec_for(tuple(x.shape), (axis,) + (None,) * (x.ndim - 1),
                    rules, mesh)


def dist_solve_specs(state, n_pool: int, mesh: Mesh,
                     rules: Optional[Rules] = None):
    """Partition specs of one distributed-solve chunk: ``(pool_spec,
    carry_spec)``, the carry being ``(lane_state, gbest, gdone, it,
    pool_heads)``.  A pool or lane count that does not divide the mesh
    degrades to replication (callers pad first, `eps.pad_pool`)."""
    rules = rules or SOLVE_RULES
    state_spec = tree_map(lambda x: _lane_spec(x, rules, mesh), state)
    pool_spec = spec_for((n_pool, 1), ("pool", None), rules, mesh)
    n_dev = int(np.prod([mesh.shape[a] for a in rules["lanes"]
                         if a in mesh.shape]))
    heads_spec = spec_for((n_dev,), ("lanes",), rules, mesh)
    carry_spec = (state_spec, P(), P(), P(), heads_spec)
    return pool_spec, carry_spec


def shard_devices(mesh: Mesh, mesh_axes: Sequence[str]) -> List:
    """The device of each shard of a leading dimension split over
    ``mesh_axes`` (the first axis major): one per index of those axes,
    at index 0 of the mesh's other axes."""
    names = mesh.axis_names
    keep = sorted(names.index(a) for a in mesh_axes)
    sub = mesh.devices[tuple(slice(None) if i in keep else 0
                             for i in range(len(names)))]
    perm = [keep.index(names.index(a)) for a in mesh_axes]
    return list(np.transpose(sub, perm).reshape(-1))


def shard_tree(tree, mesh: Mesh, axis: str = "lanes",
               rules: Optional[Rules] = None) -> List:
    """Split every leaf of ``tree`` along its leading (logical ``axis``)
    dimension into one piece per shard of ``rules[axis]``'s mesh axes,
    and place each piece on its shard's device (numpy leaves become
    tensors).  A leaf that the rule does not divide is replicated to
    every shard.  Returns the per-shard trees, in mesh order."""
    rules = rules or SOLVE_RULES
    mesh_axes = tuple(a for a in rules.get(axis, ()) if a in mesh.shape)
    devs = shard_devices(mesh, mesh_axes)
    D = len(devs)

    def piece(x, d):
        x = torch.as_tensor(x)
        spec = _lane_spec(x, rules, mesh, axis) if x.ndim else P()
        if spec and spec[0] is not None:
            x = x.reshape((D, -1) + tuple(x.shape[1:]))[d]
        return x.to(devs[d])

    return [tree_map(lambda x, d=d: piece(x, d), tree) for d in range(D)]
