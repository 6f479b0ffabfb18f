"""Exporters: JSONL event logs and Chrome-trace/Perfetto trace.json.

Chrome-trace mapping (load at https://ui.perfetto.dev or
``chrome://tracing``):

- one *track* (pid/tid pair) per node, labelled via ``thread_name``
  metadata; federation-level events (``node is None``) land on a
  dedicated ``federation`` track;
- ``round`` / ``chunk`` events become complete slices (``ph="X"``)
  spanning their virtual-time window (the event's ``t`` stamps the
  window *end*, ``detail["dur"]`` its length) with per-phase walls in
  ``args``;
- every other kind becomes a thread-scoped instant (``ph="i"``).

Timestamps are virtual-clock seconds converted to microseconds, so
one trace second equals one simulated second.
"""
from __future__ import annotations

import json
from typing import Iterable

from repro_torch.obs.events import Event

_FED_TRACK = "federation"


def events_to_dicts(events: Iterable[Event]) -> list[dict]:
    return [e.to_dict() for e in events]


def write_events_jsonl(path: str, events: Iterable[Event]) -> str:
    """One JSON object per line, in emission order."""
    with open(path, "w") as fh:
        for e in events:
            fh.write(json.dumps(e.to_dict(), sort_keys=True) + "\n")
    return path


def chrome_trace_events(events: Iterable[Event], *, pid: int = 0,
                        process_name: str | None = None) -> list[dict]:
    """Flatten one run's events into Chrome-trace ``traceEvents``."""
    out: list[dict] = []
    tids: dict[str, int] = {}
    if process_name is not None:
        out.append({"ph": "M", "pid": pid, "tid": 0,
                    "name": "process_name",
                    "args": {"name": process_name}})

    def tid_of(node: str | None) -> int:
        track = _FED_TRACK if node is None else node
        tid = tids.get(track)
        if tid is None:
            tid = tids[track] = len(tids)
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name",
                        "args": {"name": track}})
        return tid

    for e in events:
        tid = tid_of(e.node)
        detail = e.detail or {}
        args = {"round": e.round}
        if e.tenant is not None:
            args["tenant"] = e.tenant
        if e.slot >= 0:
            args["slot"] = e.slot
        if e.cause is not None:
            args["cause"] = e.cause
        args.update(detail)
        if e.is_span:
            dur_s = float(detail.get("dur", 0.0))
            out.append({"ph": "X", "pid": pid, "tid": tid,
                        "name": e.kind, "cat": "obs",
                        "ts": (e.t - dur_s) * 1e6,
                        "dur": dur_s * 1e6, "args": args})
        else:
            out.append({"ph": "i", "pid": pid, "tid": tid,
                        "name": e.kind, "cat": "obs",
                        "ts": e.t * 1e6, "s": "t", "args": args})
    return out


def write_chrome_trace(path: str,
                       groups: dict[str, Iterable[Event]]) -> str:
    """Write a Chrome-trace JSON file.

    ``groups`` maps a process label (e.g. the policy key of one run)
    to that run's events; each group gets its own pid so multi-policy
    scenario results stay side by side in the Perfetto timeline.
    """
    trace_events: list[dict] = []
    for pid, (label, events) in enumerate(groups.items()):
        trace_events.extend(chrome_trace_events(
            events, pid=pid, process_name=label))
    payload = {"traceEvents": trace_events, "displayTimeUnit": "ms"}
    with open(path, "w") as fh:
        json.dump(payload, fh)
    return path
