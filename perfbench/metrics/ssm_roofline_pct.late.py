"""The state-space scan kernel's share of its roofline: the least time the
profiled rounds' scans need (the recurrence's operations at the card's bf16
peak, x, dt, B and C read and y written once, a batch and Mamba-2 layer;
``yardstick_hybrid.py``) over the device time of ``csrc/ssm.cu``'s kernel."""

from perfbench.readers import roofline_pct

KERNELS = ("ssm_scan_kernel",)


def read(run):
    if run.trace is None:
        return None
    work = run.session.required(run.profiled).get("ssm")
    return roofline_pct(run, KERNELS, work) if work else None
