"""Share of the traced stretch in which the device sat idle while the host
tokenized captions: the idle gaps the trace names by the port's
``mme.encode.tokenize`` range, on the profiler's own clock."""


def read(run):
    tally = getattr(getattr(run.session, "engine", None), "tally", None)
    if run.trace is None or run.trace.window_s <= 0 or tally is None or not tally.n_spans.get("encode.tokenize"):
        return None
    return 100.0 * run.trace.idle.get("mme.encode.tokenize", 0.0) / run.trace.window_s
