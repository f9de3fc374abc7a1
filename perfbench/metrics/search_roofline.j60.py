"""search_roofline.j60 (%, device trace), in j60-deadline, the dense
Cumulative bank: `readers.search_roofline`."""

from readers import search_roofline as read  # noqa: F401
