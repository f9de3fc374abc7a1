"""superstep_ms.j60 (ms, the program's counters and clock), in
j60-deadline, the dense Cumulative bank: `readers.superstep_ms`."""

from readers import superstep_ms as read  # noqa: F401
