"""nodes_per_s.j120 (nodes/s, host clock), in j120-deadline, the sparse
Cumulative bank: `readers.nodes_per_s`."""

from readers import nodes_per_s as read  # noqa: F401
