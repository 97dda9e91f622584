"""The device trace of a run's traced slice, and what it says.

``torch.profiler`` records the host's ops and the device's activities
(kernels, copies, fills) over the slice. The slice's bounds are the
benchmark's own ``bench.window`` range, which ends after a synchronise, so
every activity it launched lies inside it. From that:

* ``busy_s``: the union of the device's activity intervals inside the slice;
  ``window_s`` its length; the idle share is one less their ratio;
* the device time of the activities whose names match a list;
* the breakdown: the device activities that took most time, and the longest
  idle gaps named by what the host was doing then (the innermost host op
  open at the gap's middle).
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

import torch

__all__ = ["Trace", "Tracer"]

WINDOW_RANGE = "bench.window"
_NAME_CHARS = 160  # a kernel's demangled name is cut to this many characters
_GAPS_NAMED = 500  # the longest idle gaps that are named


@dataclass
class Trace:
    """Device activities and host ops of one traced slice, in ns."""

    start: int
    end: int
    device: list = field(default_factory=list)  # (name, start, end)
    host: list = field(default_factory=list)  # (name, start, end), sorted by start

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def intervals(self):
        """The device's busy intervals inside the slice, merged, in order."""
        spans = sorted((max(s, self.start), min(e, self.end)) for _, s, e in self.device)
        merged = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) / 1e9

    def device_seconds(self, patterns) -> float:
        """Device time of the activities whose names hold one of ``patterns``."""
        return sum(e - s for name, s, e in self.device
                   if any(p in name for p in patterns)) / 1e9

    def gaps(self):
        """The idle intervals inside the slice."""
        out, at = [], self.start
        for s, e in self.intervals():
            if s > at:
                out.append((at, s))
            at = e
        if self.end > at:
            out.append((at, self.end))
        return out

    def _host_at(self, starts, t: int) -> str:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            name, s, e = self.host[i]
            if e >= t and name != WINDOW_RANGE:
                return name
            i -= 1
        return "(no host op)"

    def breakdown(self) -> dict:
        """The ten device activities that took most time, and the idle time of
        the longest gaps summed by what the host was doing, ten names."""
        by_kernel: dict = {}
        for name, s, e in self.device:
            key = name[:_NAME_CHARS]
            by_kernel[key] = by_kernel.get(key, 0) + (e - s)
        by_host: dict = {}
        starts = [h[1] for h in self.host]
        for s, e in sorted(self.gaps(), key=lambda g: g[0] - g[1])[:_GAPS_NAMED]:
            key = self._host_at(starts, (s + e) // 2)[:_NAME_CHARS]
            by_host[key] = by_host.get(key, 0) + (e - s)

        def top(d):
            return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

        return {"device_ops": top(by_kernel), "idle_gaps": top(by_host)}


class Tracer:
    """Profiles the slice between :meth:`start` and :meth:`stop` on a CUDA
    device; on the CPU it records nothing and :attr:`trace` stays None."""

    def __init__(self, device: torch.device):
        self.device = device
        self.trace = None
        self._prof = None
        self._range = None

    def start(self):
        if self.device.type != "cuda":
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize(self.device)
        self._range = record_function(WINDOW_RANGE)
        self._range.__enter__()

    def stop(self):
        if self._prof is None:
            return
        torch.cuda.synchronize(self.device)
        self._range.__exit__(None, None, None)
        self._prof.stop()
        self.trace = _read(self._prof)
        self._prof = None

    @contextlib.contextmanager
    def span(self, name: str):
        """A host range in the trace while profiling, else nothing."""
        if self._prof is None:
            yield
            return
        from torch.profiler import record_function

        with record_function(name):
            yield


def _read(prof) -> Trace:
    events = prof.profiler.kineto_results.events()
    window = [e for e in events if e.name() == WINDOW_RANGE]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE} range")
    start, end = window[0].start_ns(), window[0].end_ns()
    device, host = [], []
    for e in events:
        rec = (e.name(), e.start_ns(), e.end_ns())
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            host.append(rec)
        elif rec[2] > start and rec[1] < end and not e.is_user_annotation():
            device.append(rec)  # a host range mirrored on the device's timeline is no activity
    host.sort(key=lambda h: h[1])
    return Trace(start, end, device, host)
