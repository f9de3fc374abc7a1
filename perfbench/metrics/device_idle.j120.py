"""device_idle.j120 (%, device trace), in j120-deadline, the sparse
Cumulative bank: `readers.device_idle`."""

from readers import device_idle as read  # noqa: F401
