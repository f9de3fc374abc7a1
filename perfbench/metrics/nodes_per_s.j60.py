"""nodes_per_s.j60 (nodes/s, host clock), in j60-deadline, the dense
Cumulative bank: `readers.nodes_per_s`."""

from readers import nodes_per_s as read  # noqa: F401
