"""The KDA kernel's share of its roofline: the least time the profiled
rounds' KDA layers need (the recurrence's 7 K V operations a token and head at
the card's bf16 peak, or q, k and v read and o written once in bf16 with g and
beta read once in f32, whichever is longer, a batch and KDA layer;
``yardstick_kda.py``, counted the same whatever implements the layer) over
the device time of every kernel named ``kda_scan_kernel`` (``csrc/kda.cu``)."""

from perfbench.readers import roofline_pct

KERNELS = ("kda_scan_kernel",)


def read(run):
    if run.trace is None:
        return None
    work = run.session.required(run.profiled).get("kda")
    return roofline_pct(run, KERNELS, work) if work else None
