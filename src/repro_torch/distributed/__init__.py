"""Distributed pieces of the port: the solver halves of
``repro/distributed/`` (`planner`, `collectives`, `sharding`).

The port's mesh is in-process: a `sharding.Mesh` holds D ``torch.device``
entries (all on one card unless the caller passes several), one host loop
drives every shard, and a collective reduces the D per-shard values
(`collectives`).  The training halves (`int8_psum_mean`, `psum_mean`,
`pod_sync_grads`, the train/serve rules and the cache shardings) are not
ported yet.
"""
