"""device_idle.first (%, device trace), in the cells run to a first
schedule: `readers.device_idle`."""

from readers import device_idle as read  # noqa: F401
