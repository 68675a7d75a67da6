"""The whole step's share of the card's bf16 peak: the required operations
of the profiled units (``yardstick.py``) over the traced stretch's seconds."""

from perfbench.readers import mfu_pct


def read(run):
    return mfu_pct(run)
