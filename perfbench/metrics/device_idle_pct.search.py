"""Share of the traced stretch in which no kernel, copy or set ran on the
device."""

from perfbench.readers import idle_pct


def read(run):
    return idle_pct(run)
