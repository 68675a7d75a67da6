"""Images a second: the images of every completed round over the seconds
from the window's start to the end of its last round (a round: the image
sweep, both caption sweeps and the dense scores)."""


def read(run):
    return sum(r["images"] for r in run.records) / run.window_s
