"""superstep_ms.j120 (ms, the program's counters and clock), in
j120-deadline, the sparse Cumulative bank: `readers.superstep_ms`."""

from readers import superstep_ms as read  # noqa: F401
