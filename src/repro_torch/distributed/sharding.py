"""Logical-axis sharding rules and the in-process mesh — the solver half
of ``repro/distributed/sharding.py``.

A rule table maps *logical* axis names to mesh axes; `spec_for` drops a
mapping that does not divide the concrete dimension, so an odd size
degrades to replication, never to an invalid split.  The distributed EPS
solver (`core/dist_solve.py`) shards the lane batch and the subproblem
pool over the 1-D ``solve`` axis (`SOLVE_RULES`).

`Mesh` is the port's counterpart of ``jax.sharding.Mesh``: an ndarray of
``torch.device`` entries with axis names.  Its entries may repeat: by
default (`make_mesh`) every shard sits on the one device asked for, the
torch counterpart of the reference's fake host devices.  `shard_tree` is
the counterpart of ``NamedSharding`` plus ``device_put``: it splits each
leaf's leading axis into per-shard pieces and places each piece on its
shard's device.

The train/serve rule tables and the cache shardings are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device

Rules = Dict[str, Tuple[str, ...]]

# distributed EPS solver: the lane batch and the subproblem pool both
# shard over the 1-D `solve` axis; model tables and the scalar
# bound/flags are replicated
SOLVE_RULES: Rules = {
    "lanes": ("solve",),
    "pool": ("solve",),
}


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


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices=None, device=None) -> Mesh:
    """A `Mesh` of ``shape`` over ``devices`` (the first prod(shape) of
    them, in order), or, without ``devices``, every entry ``device``
    (``None``: the card; it raises when there is none)."""
    n = int(np.prod(shape))
    if devices is None:
        devs = [resolve_device(device)] * n
    else:
        devs = [resolve_device(d) for d in devices]
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
