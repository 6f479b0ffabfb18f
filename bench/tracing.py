"""The device trace of the last part of a window: ``torch.profiler``
with CUDA activity alone (host operations are not recorded: recording
them doubled the host's decode step), read into kernels on the host
clock.

Each kernel keeps the host time of the call that launched it (the
midpoint of the runtime or driver call). The profiler's clock is
aligned with ``time.perf_counter`` by marker kernels launched as the
trace starts and as the window closes, each between two host readings,
and told from the program's kernels by their name (``torch.cuda._sleep``'s
spin kernel, which the program never launches; see :func:`align`). The
expert products are the kernels launched inside a ``torch.bmm`` call:
from the trace's start to the loop's end, ``torch.bmm`` (called by the
MoE layer alone) is wrapped to record its host intervals; the
hand-written kernels are told by name."""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

#: marker launches that align the profiler's clock with the host's
MARKS = 5
#: the marker kernel's name, as the trace gives it
MARK_NAME = "spin_kernel"


@dataclass
class Kernel:
    name: str
    start: float        # host clock, s
    dur: float          # s
    launch: float       # host time of the runtime call that launched it


@dataclass
class Trace:
    t0: float           # traced window on the host clock
    t1: float
    kernels: list[Kernel]
    bmm_calls: list[tuple[float, float]] = field(default_factory=list)
    begun: float | None = None  # when the loop began to start the trace
    _bmm_starts: list[float] = field(default_factory=list, repr=False)

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals, in order."""
        out: list[list[float]] = []
        for k in sorted(self.kernels, key=lambda k: k.start):
            a, b = k.start, k.start + k.dur
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_within(self, spans) -> float:
        """Seconds of the union of device intervals inside ``spans``
        (sorted, disjoint (t0, t1, ...) host intervals)."""
        busy = self.busy()
        starts = [a for a, _ in busy]
        total = 0.0
        for s in spans:
            a, b = s[0], s[1]
            i = max(bisect.bisect_right(starts, a) - 1, 0)
            while i < len(busy) and busy[i][0] < b:
                lo, hi = max(a, busy[i][0]), min(b, busy[i][1])
                if hi > lo:
                    total += hi - lo
                i += 1
        return total

    def device_in(self, spans, keep) -> float:
        """Seconds of the kernels that ``keep`` accepts and that a call
        inside one of ``spans`` (disjoint host (t0, t1, ...) intervals)
        launched."""
        spans = sorted(spans)
        starts = [s[0] for s in spans]
        total = 0.0
        for k in self.kernels:
            if not keep(k):
                continue
            i = bisect.bisect_right(starts, k.launch) - 1
            if i >= 0 and k.launch < spans[i][1]:
                total += k.dur
        return total

    def launched_by_bmm(self, k: Kernel) -> bool:
        if len(self._bmm_starts) != len(self.bmm_calls):
            self._bmm_starts = [a for a, _ in self.bmm_calls]
        i = bisect.bisect_right(self._bmm_starts, k.launch) - 1
        return i >= 0 and k.launch <= self.bmm_calls[i][1]


def _marks() -> list[tuple[int, int]]:
    """Launch the marker kernels, each between two host readings (ns)."""
    out = []
    for _ in range(MARKS):
        torch.cuda.synchronize()
        a = time.perf_counter_ns()
        torch.cuda._sleep(1)
        out.append((a, time.perf_counter_ns()))
    return out


def align(calls, starts, ends):
    """The map from the profiler's clock to the host's, in ns.

    ``calls`` are the (start, duration) of the recorded marker launches,
    in order; ``starts`` and ``ends`` the host brackets of those launched
    as the trace starts and as the window closes. Each launch call lies
    inside its bracket, which bounds the offset between the clocks. The
    profiler may drop the first events of a trace, so the recorded calls
    are paired from the end: every end mark is recorded, and the start
    marks that are recorded are the last of theirs. With both, the offset
    is interpolated linearly between them. Returns the map, the room
    (ns) the brackets leave for each offset (below 0 they disagree), and
    the host time (ns) of the first recorded start mark, or None."""
    def fit(cs, bs):
        lo = max(c + d - b for (c, d), (_, b) in zip(cs, bs))
        hi = min(c - a for (c, _), (a, _) in zip(cs, bs))
        return 0.5 * (lo + hi), hi - lo, cs[0][0]

    n = len(ends)
    if len(calls) < n:
        raise RuntimeError("the trace lacks the window's marker kernels")
    fits = [fit(calls[-n:], ends)]
    k = min(len(calls) - n, len(starts))
    first = None
    if k:
        fits.insert(0, fit(calls[-n - k:-n], starts[-k:]))
        first = starts[-k][0]
    if len(fits) == 1 or fits[0][1] < 0:
        off = fits[-1][0]
        return (lambda ns: ns - off), [f[1] for f in fits], first
    (o0, _, p0), (o1, _, p1) = fits
    rate = (o1 - o0) / (p1 - p0)
    return (lambda ns: ns - (o0 + rate * (ns - p0))), \
        [f[1] for f in fits], first


class Tracer:
    """Started by the run's loop part-way into the window; stopped once
    the loop has ended, and read up to the window's close."""

    #: wait after the profiler starts before the first marker: the
    #: profiler drops events of a trace's first moments
    SETTLE_S = 0.25

    def __init__(self):
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0 = self.t1 = self.begun = None
        self.bmm_calls: list[tuple[float, float]] = []
        self._bmm = None

    def start(self) -> None:
        self.begun = time.perf_counter()
        torch.cuda.synchronize()
        self.prof.__enter__()
        time.sleep(self.SETTLE_S)
        self.starts = _marks()
        self.t0 = self.starts[0][0] / 1e9
        self._bmm = torch.bmm
        calls, bmm, clock = self.bmm_calls, self._bmm, time.perf_counter

        def traced_bmm(*args, **kwargs):
            a = clock()
            out = bmm(*args, **kwargs)
            calls.append((a, clock()))
            return out
        torch.bmm = traced_bmm

    def pause(self) -> None:
        """Mark the window's close and launch the end markers. The
        profiler and the ``torch.bmm`` wrapper run on through the drain,
        so a call that started in the window is traced whole, and are
        stopped after the loop (the profiler's stop takes tens of
        seconds, which would stall it)."""
        self.t1 = time.perf_counter()
        self.ends = _marks()

    def stop(self) -> None:
        if self._bmm is not None:
            torch.bmm = self._bmm
            self._bmm = None
        if self.t1 is None:
            self.pause()
        self.prof.__exit__(None, None, None)

    def read(self, t1: float) -> Trace:
        """The kernels, on the host clock, of the window up to ``t1``;
        the window starts at the first recorded start marker."""
        launch, dev = {}, []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                dev.append((e.start_ns(), e.duration_ns(),
                            e.correlation_id(), e.name()))
                continue
            # the launch call is the first host event of its correlation
            # (module loading and buffer requests may share it)
            c, start = e.correlation_id(), e.start_ns()
            if c not in launch or start < launch[c][0]:
                launch[c] = (start, e.duration_ns())
        dev.sort()
        calls = [launch[d[2]] for d in dev
                 if MARK_NAME in d[3] and d[2] in launch]
        host_ns, self.align_room_ns, first = align(calls, self.starts,
                                                   self.ends)
        kernels = []
        for s, d, c, name in dev:
            if MARK_NAME in name:
                continue
            ls, ld = launch.get(c, (s, 0))
            kernels.append(Kernel(name, host_ns(s) / 1e9, d / 1e9,
                                  host_ns(ls + ld / 2) / 1e9))
        if first is not None:
            t0 = first / 1e9
        else:
            t0 = max(self.t0, min((k.start for k in kernels), default=t1))
        return Trace(t0, t1, kernels, self.bmm_calls, self.begun)


def warm() -> None:
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up, seconds) happens in set-up and not inside the window."""
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
