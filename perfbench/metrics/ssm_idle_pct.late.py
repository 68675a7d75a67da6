"""Share of the traced stretch in which the device sat idle while the host
was inside the state-space layers' own code: the idle gaps the trace names by
the port's ``mme.ssm.in``, ``mme.ssm.scan`` and ``mme.ssm.out`` ranges
(``models/granite.py``) or by the scan wrapper's ``mme.kernel.ssm_scan``
(``ops/ssm_cuda.py``), which lies inside ``mme.ssm.scan``, on the profiler's
own clock."""


def read(run):
    tally = getattr(getattr(run.session, "lm", None), "tally", None)
    if run.trace is None or run.trace.window_s <= 0 or tally is None or not tally.n_spans.get("ssm.scan"):
        return None
    idle = sum(t for name, t in run.trace.idle.items()
               if name.startswith("mme.ssm.") or name == "mme.kernel.ssm_scan")
    return 100.0 * idle / run.trace.window_s
