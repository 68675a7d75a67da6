"""The preprocess kernel's share of its roofline: the profiled rounds'
images read once and their f32 crops written once, over the memory
bandwidth, against the device time of ``csrc/preprocess.cu``'s kernel."""

from perfbench.readers import roofline_pct

KERNELS = ("preprocess_kernel",)


def read(run):
    if run.trace is None:
        return None
    return roofline_pct(run, KERNELS, [(0.0, run.session.required(run.profiled)["preprocess_bytes"])])
