"""The attention kernel's share of its roofline: the least time the
profiled rounds' attention needs (the pairs the masks leave, each q, k, v
and o byte once; ``yardstick.py``) over the device time of the kernel's
``__global__`` functions (``csrc/attention.cu``)."""

from perfbench.readers import roofline_pct

KERNELS = ("flash_kernel", "flash_f32_kernel")


def read(run):
    if run.trace is None:
        return None
    return roofline_pct(run, KERNELS, run.session.required(run.profiled)["attention"])
