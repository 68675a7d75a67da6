"""Share of the traced stretch in which the device sat idle while the host
was inside the KDA layers' own code: the idle gaps the trace names by the
port's ``mme.kda.in``, ``mme.kda.scan`` and ``mme.kda.out`` ranges
(``models/kimi_linear.py``) or by the kernel wrapper's
``mme.kernel.kda_scan`` (``ops/kda_cuda.py``), which lies inside
``mme.kda.scan``, on the profiler's own clock."""


def read(run):
    tally = getattr(getattr(run.session, "lm", None), "tally", None)
    if run.trace is None or run.trace.window_s <= 0 or tally is None or not tally.n_spans.get("kda.scan"):
        return None
    idle = sum(t for name, t in run.trace.idle.items()
               if name.startswith("mme.kda.") or name == "mme.kernel.kda_scan")
    return 100.0 * idle / run.trace.window_s
