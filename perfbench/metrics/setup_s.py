"""setup_s (s, host clock): from the process's start to the window's:
imports, the card's context, the kernels' build or load, one warm solve
of the cell's own shapes and the generation of the mix's instance set."""


def read(run):
    return run.setup_s
