"""search_roofline.j120 (%, device trace), in j120-deadline, the sparse
Cumulative bank: `readers.search_roofline`."""

from readers import search_roofline as read  # noqa: F401
