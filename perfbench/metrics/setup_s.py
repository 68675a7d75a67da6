"""Set-up seconds: from the process's start through loading the weights and
inputs and the warm-up, to the window's start."""


def read(run):
    return run.setup_s
