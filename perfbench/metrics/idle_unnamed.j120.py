"""idle_unnamed.j120 (%, device trace and the program's spans), in
j120-deadline: the share of the card's idle time that no phase of the program
and no build or compile of the harness covers: `spans.idle_unnamed`."""

from spans import idle_unnamed as read  # noqa: F401
