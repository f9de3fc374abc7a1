"""quantum_host_ms.j120 (ms, the program's spans), in j120-deadline: host
milliseconds per resident launch outside its read, the phases up to and
at the enqueue and the bookkeeping between quanta:
`spans.quantum_host_ms`."""

from spans import quantum_host_ms as read  # noqa: F401
