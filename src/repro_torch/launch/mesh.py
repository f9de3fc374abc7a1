"""Production and host meshes (the port of ``repro/launch/mesh.py``).

`make_production_mesh` lays out the reference's production mesh over
``meta`` entries: it places nothing and launches nothing, and only the
dry-run (`launch/dryrun.py`, ``launch/solve.py --dryrun``) reads it.
`make_host_mesh` is the 1-D mesh that training ranks shard their params
and batch over (`train/train_step.py`, ``launch/train.py --devices N``).
"""

from __future__ import annotations

from repro_torch.distributed.sharding import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 = 256 chips per pod; multi_pod adds a leading 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device="meta")


def make_host_mesh(n: int = 1, axis: str = "data", devices=None,
                   device=None) -> Mesh:
    """The 1-D ``{axis: n}`` mesh over ``devices`` (one per rank), or
    with every entry ``device`` (``None``: the card)."""
    return make_mesh((n,), (axis,), devices=devices, device=device)
