"""The routed experts' grouped products' share of their roofline: the least
time the profiled rounds' routed rows need (each row through its expert's
gate, up and down, every expert's weights read once a batch and MoE layer,
the rows in and out once; ``yardstick_moe.py``) over the device time of the
grouped product's kernels. ``torch._grouped_mm`` on bf16 runs CUTLASS's
grouped GEMM, whose mangled name the card's trace prints as one identifier
(``_ZN7cutlass13device_kernelI...GemmUniversalINS5_17GroupProblemShape...``),
so a kernel counts where its name holds ``GroupProblemShape``."""

from perfbench.yardstick import bound_s

MARK = "GroupProblemShape"


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    seconds = sum(t for name, t in run.trace.kernels.items() if MARK in name)
    work = run.session.required(run.profiled).get("experts")
    if seconds <= 0 or not work:
        return None
    return 100.0 * sum(bound_s(f, b, run.peaks) for f, b in work) / seconds
