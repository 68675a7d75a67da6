"""Host milliseconds a profiled round spends tokenizing captions: the
engine's ``encode.tokenize`` span seconds (``utils/profiling.py``, recorded
only while the profiler runs, so over the profiled rounds alone) over those
rounds."""


def read(run):
    tally = getattr(getattr(run.session, "engine", None), "tally", None)
    if tally is None or not run.profiled or not tally.n_spans.get("encode.tokenize"):
        return None
    return 1e3 * tally.seconds["encode.tokenize"] / len(run.profiled)
