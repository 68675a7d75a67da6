"""The 95th percentile of a search request's latency over every request of
the window, in ms: from the client's call to the top-k ids on the host."""

import numpy as np


def read(run):
    return 1e3 * float(np.percentile([r["latency_s"] for r in run.records], 95))
