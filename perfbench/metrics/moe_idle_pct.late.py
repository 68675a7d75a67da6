"""Share of the traced stretch in which the device sat idle while the host
was inside the MoE layers' own code: the idle gaps the trace names by the
port's ``mme.moe.route``, ``mme.moe.experts`` and ``mme.moe.combine``
ranges (``ops/moe.py``), on the profiler's own clock."""


def read(run):
    tally = getattr(getattr(run.session, "lm", None), "tally", None)
    if run.trace is None or run.trace.window_s <= 0 or tally is None or not tally.n_spans.get("moe.route"):
        return None
    idle = sum(t for name, t in run.trace.idle.items() if name.startswith("mme.moe."))
    return 100.0 * idle / run.trace.window_s
