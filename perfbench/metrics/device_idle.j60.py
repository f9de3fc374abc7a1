"""device_idle.j60 (%, device trace), in j60-deadline, the dense Cumulative
bank: `readers.device_idle`."""

from readers import device_idle as read  # noqa: F401
