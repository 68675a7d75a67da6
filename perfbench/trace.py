"""Reduce a ``torch.profiler`` trace of the traced stretch to what the
per-layer metrics read: the device's busy seconds, each kernel's device
seconds, and the idle gaps named by what the host was doing.

The stretch is the harness's ``perfbench.traced`` range, which opens and
closes on a synchronized device. Busy time is the union of every device
interval inside it (kernels, copies, sets) over all streams. An idle gap is
a stretch of that range with nothing on the device; it is named by the
innermost host range or operator open on the harness's thread at its
middle. Nothing is written to disk.
"""

from __future__ import annotations

import re
from collections import Counter

TRACED = "perfbench.traced"
TOP = 10


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class Trace:
    """The traced stretch of one run, from the profiler's events."""

    def __init__(self, events):
        from torch.autograd import DeviceType

        rng = next(e for e in events if e.name() == TRACED and e.device_type() == DeviceType.CPU)
        t0, t1, thread = rng.start_ns(), rng.end_ns(), rng.start_thread_id()
        self.window_s = (t1 - t0) * 1e-9
        device, host = [], []
        kernels: Counter = Counter()
        for e in events:
            s, d = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():  # a range's mirror, no work
                s, end = max(s, t0), min(s + d, t1)
                if end > s:
                    device.append((s, end))
                    kernels[e.name()] += (end - s) * 1e-9
            elif e.start_thread_id() == thread and d > 0 and e.name() != TRACED and t0 <= s < t1:
                host.append((s, s + d, e.name()))
        busy = _union(device)
        self.busy_s = sum(e - s for s, e in busy) * 1e-9
        self.kernels = kernels
        bounds = [t0] + [x for iv in busy for x in iv] + [t1]
        gaps = [(bounds[i], bounds[i + 1]) for i in range(0, len(bounds), 2) if bounds[i + 1] > bounds[i]]
        self.idle = self._name_gaps(gaps, host)

    @staticmethod
    def _name_gaps(gaps, host) -> Counter:
        """Idle seconds by the innermost host event open at each gap's middle."""
        host.sort(key=lambda h: (h[0], -h[1]))  # an enclosing event before the events it holds
        idle: Counter = Counter()
        stack: list[tuple[int, int, str]] = []  # the events open at the sweep's time, outermost first
        j = 0
        for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (s + e) // 2
            while j < len(host) and host[j][0] <= mid:
                while stack and stack[-1][1] <= host[j][0]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            idle[stack[-1][2] if stack else "host (no range open)"] += (e - s) * 1e-9
        return idle

    def kernel_seconds(self, names: tuple[str, ...]) -> float:
        """Device seconds of the kernels whose name holds one of ``names`` as
        a whole identifier (``flash_kernel`` in ``void flash_kernel<64>(Params)``)."""
        pats = [re.compile(rf"(?<![A-Za-z0-9_]){re.escape(n)}(?![A-Za-z0-9_])") for n in names]
        return sum(t for k, t in self.kernels.items() if any(p.search(k) for p in pats))

    def breakdown(self) -> dict:
        """The device operations that took most time, and the host activities
        under which the device sat idle longest, in seconds."""
        return {"device_ops": [[n[:160], t] for n, t in self.kernels.most_common(TOP)],
                "idle_gaps": [[n[:160], t] for n, t in self.idle.most_common(TOP)]}
