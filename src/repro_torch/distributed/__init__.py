"""Distributed pieces of the port (``repro/distributed/``): `planner`,
`collectives`, `sharding`.

The solver's mesh is in-process: a `sharding.Mesh` holds D
``torch.device`` entries (all on one card unless the caller passes
several), one host loop drives every shard, and a collective reduces the
D per-shard values.  Training runs one process per rank over a
``torch.distributed`` process group: the gradient collectives
(`collectives.psum_mean`, `int8_psum_mean`, `pod_sync_grads`) and the
train/serve rule tables and cache shardings (`sharding`).
"""
