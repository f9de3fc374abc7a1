"""eps_host_s (s, the program's spans), in j120-first: the mean over the
window's solves of EPS's host phases, every ``eps.*`` phase of the
solve's trace but the wait on the copy back: `spans.eps_host_s`."""

from spans import eps_host_s as read  # noqa: F401
