"""first_s (s, host clock): the mean time from the start of building an
instance to its solve's return, over the instances that returned within
the window."""


def read(run):
    done = run.in_window()
    if not done:
        return None
    return sum(s.t_done - s.t_start for s in done) / len(done)
