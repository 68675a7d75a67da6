"""Bootstrap iterations a second: the iterations of every completed round
over the seconds from the window's start to the end of its last round (a
round: the score matrices, the bootstrap, the intervals and the failure
analysis)."""


def read(run):
    return sum(r["iterations"] for r in run.records) / run.window_s
