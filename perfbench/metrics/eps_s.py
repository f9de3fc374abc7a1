"""eps_s (s): the mean of the program's ``SolveResult.eps_s`` (its host
clock around the EPS decomposition) over the instances that returned
within the window."""


def read(run):
    done = run.in_window()
    if not done:
        return None
    return sum(s.result.eps_s for s in done) / len(done)
