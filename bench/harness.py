"""One run of one cell: set-up, the open loop, the window, the drain, the
comparison with the reference, and the result's line.

The loop is the benchmark's own: submit every request whose due time
has passed, then ``engine.step()``, which runs the tenants' prefills and
decode steps and, every ``round_interval_steps`` steps, a DYVERSE round.
Spans around the engine's prefill, decode and round calls are taken by
wrapping those calls on the engine object; nothing inside the program
changes. A traced run also hands the program's own events to the
readers: a ``repro_torch.obs.FlightRecorder`` attached to the engine for
the loop. The configuration's architecture (its ``"arch"``) is two
modules, :mod:`bench.modules`: the program's side, ``bench/arch/``, and
the weight layout and reference, ``bench/reference/``."""
from __future__ import annotations

import bisect
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from bench import check, modules, stats, traffic
from bench.record import Record
from bench.reference import weights as bw

#: top-level module names that may not be loaded once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: share of the window, at its end, that a traced run traces; the host
#: spans' metrics read the part before it, free of the profiler's cost
TRACED_SHARE = 1 / 3

#: events the program's recorder holds: a traced run of either cell emits
#: 4,137 to 5,766 (H100), so 2^18 holds some 45 times that, and room for
#: busier cells; a reader reads none where any drop
EVENT_CAPACITY = 1 << 18


def load_spec(root: Path, cell: str) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, the cell's entry, its configuration, its traffic)."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"unknown workload {cell!r}")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    return spec, entry, cfg, traffic.load(root, entry["traffic"])


def _seeds(seed: int, tenants: int) -> tuple:
    """(traffic's seed sequence, the tenants' weight seeds, the sample's
    generator) of a run's ``--seed``."""
    ss = np.random.SeedSequence(seed)
    tr, ws, sm = ss.spawn(3)
    wseeds = [int(s.generate_state(1)[0]) for s in ws.spawn(tenants)]
    return tr, wseeds, np.random.default_rng(sm)


def _wrap(eng, rec: Record, clock, resumed: dict) -> None:
    """Record spans around the engine's prefill, decode and round calls."""
    prefill, decode, rnd = (eng._prefill_into_slot, eng._decode_step,
                            eng.ctrl.run_round)

    def prefill_span(rt, rs, slot):
        back = bool(rs.generated)
        ctx = len(rs.req.prompt) + (len(rs.generated) - 1 if back else 0)
        t0 = clock()
        prefill(rt, rs, slot)
        rec.prefills.append((t0, clock(), rt.name, rs.req.rid, ctx, back))
        if back:
            resumed[rs.req.rid] = resumed.get(rs.req.rid, 0) + 1

    def decode_span(rt):
        lens = [int(rt.pos[i]) + 1 for i, r in enumerate(rt.slot_req)
                if r is not None]
        t0 = clock()
        decode(rt)
        rec.decodes.append((t0, clock(), rt.name, lens))

    def round_span():
        t0 = clock()
        out = rnd()
        rec.rounds.append((t0, clock()))
        rec.quotas.append((t0, {n: q.quota.slots
                                for n, q in eng.sched.tenants.items()}))
        return out

    eng._prefill_into_slot = prefill_span
    eng._decode_step = decode_span
    eng.ctrl.run_round = round_span


def _unwrap(eng) -> None:
    for obj, name in ((eng, "_prefill_into_slot"), (eng, "_decode_step"),
                      (eng.ctrl, "run_round")):
        obj.__dict__.pop(name, None)


def _busy(eng) -> bool:
    return any(tq.active or tq.waiting for tq in eng.sched.tenants.values())


def _warm(eng, t: dict, names: list[str], vocab: int) -> None:
    """Run the cell's own shapes once: a prefill at the shortest, median
    and longest prompt and a few decode steps in each tenant."""
    rng = np.random.default_rng(0)
    p = t["prompt"]
    for name in names:
        for n in (p["min"], p["median"], p["max"]):
            eng.submit(name, rng.integers(0, vocab, n).tolist(),
                       max_new_tokens=4)
    eng.drain(max_steps=200)


def load_metric(root: Path, name: str):
    """The reader of per-layer metric ``name``: ``bench/metrics/<name>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    return modules.load(path, f"bench.metrics.{name}").read


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN)


class Setup:
    """A cell's engine with its tenants admitted, the benchmark's weights
    handed in and the cell's shapes warmed; ``arch``, the program's side
    of the configuration's architecture."""

    def __init__(self, root: Path, cell: str, seed: int, *, device: str,
                 cfg_over: dict | None = None,
                 traffic_over: dict | None = None):
        from repro_torch.core import TenantSpec
        from repro_torch.serving.engine import EngineConfig, MultiTenantEngine

        self.spec, self.entry, cfg, t = load_spec(root, cell)
        self.cfg = {**cfg, **(cfg_over or {})}
        self.t = {**t, **(traffic_over or {})}
        self.cell, self.device = cell, device
        self.arch = modules.program(self.cfg, root)
        mcfg = self.arch.program_config(self.cfg)
        self.names = [x["name"] for x in self.t["tenants"]]
        self.traffic_ss, self.wseeds, self.sample_rng = _seeds(
            seed, len(self.names))
        self.eng = MultiTenantEngine(EngineConfig(**self.t["engine"]),
                                     seed=0, device=device)
        for x, ws in zip(self.t["tenants"], self.wseeds):
            ok = self.eng.add_tenant(TenantSpec(
                name=x["name"], slo_latency=x["slo_s"], premium=x["premium"],
                arch=self.cfg["name"], max_units=x["max_units"],
                min_units=x["min_units"]), mcfg)
            if not ok:
                raise RuntimeError(f"tenant {x['name']} not admitted")
            w = bw.make(self.cfg, ws, device, root)
            self.arch.hand_in(self.eng.tenants[x["name"]].params, w,
                              self.cfg)
            del w
        if device == "cuda":
            torch.cuda.empty_cache()
        _warm(self.eng, self.t, self.names, self.cfg["vocab_size"])


def open_loop(s: Setup, reqs: list[dict], seconds: float, tracer=None,
              clock=time.perf_counter, events: bool = False) -> Record:
    """Offer ``reqs`` (due times from the window's open) from now on:
    the warm-up, the window of ``seconds``, then the drain, which ends
    when every request due in the window has finished or at the drain's
    limit. The tracer, if any, runs from the start of the window's traced
    part (its last :data:`TRACED_SHARE`) to the end. With ``events``, a
    flight recorder observes the engine for the loop, and the record
    gets its events."""
    eng, t = s.eng, s.t
    t0 = clock()
    w0 = t0 + t["warmup_s"]
    w1 = w0 + seconds
    ts = w1 - seconds * TRACED_SHARE
    limit = w1 + t["drain_limit_s"]
    rec = Record(s.cell, s.cfg, (w0, w1), 0.0, [], arch=s.arch)
    resumed: dict[int, int] = {}
    obs = None
    if events:
        from repro_torch.obs import FlightRecorder
        obs = FlightRecorder(EVENT_CAPACITY)
        eng.attach_recorder(obs)
    _wrap(eng, rec, clock, resumed)
    window = [r for r in reqs if 0 <= r["due"] < seconds]
    nxt, n = 0, len(reqs)
    while True:
        now = clock()
        while nxt < n and w0 + reqs[nxt]["due"] <= now:
            r = reqs[nxt]
            r["rs"] = eng.submit(s.names[r["tenant"]], r["prompt"],
                                 max_new_tokens=r["answer"])
            nxt += 1
        if tracer is not None:
            if tracer.t0 is None and now >= ts:
                tracer.start()
            elif tracer.t1 is None and now >= w1:
                tracer.pause()
        if now >= w1 and (now >= limit or all(
                r["rs"].finish_t is not None for r in window)):
            break
        if not _busy(eng):
            wait = w0 + reqs[nxt]["due"] - now if nxt < n else 1e-3
            time.sleep(min(max(wait, 0.0), 1e-3))
            continue
        a = clock()
        eng.step()
        rec.steps.append((a, clock()))
    rec.t_stop = clock()
    _unwrap(eng)
    if obs is not None:
        eng.attach_recorder(None)
        rec.events, rec.events_dropped = obs.events_list(), obs.dropped
    slo = [x["slo_s"] for x in t["tenants"]]
    for r in reqs:
        rs = r.get("rs")
        if rs is None:
            continue
        rec.requests.append({
            "rid": rs.req.rid, "tenant": r["tenant"], "due": w0 + r["due"],
            "prompt": len(r["prompt"]), "generated": len(rs.generated),
            "first": rs.first_token_t, "finish": rs.finish_t,
            "cloud": rs.phase.value == "evicted", "slo": slo[r["tenant"]],
            "resumed": resumed.get(rs.req.rid, 0),
            "done": rs.phase.value == "done",
            "tokens": r["prompt"], "served": list(rs.generated)})
    return rec


def run(root: Path, cell: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", cfg_over: dict | None = None,
        traffic_over: dict | None = None, fault=None,
        control: bool = False, log=None) -> dict:
    """One run; returns the result's line as a dict. ``cfg_over`` and
    ``traffic_over`` replace keys of the cell's files, ``fault(engine)``
    breaks the engine after set-up, and ``control`` also reads the
    control: for the tests and the calibration only."""
    clock = time.perf_counter
    s = Setup(root, cell, seed, device=device, cfg_over=cfg_over,
              traffic_over=traffic_over)
    reqs = traffic.generate(s.t, seconds, s.traffic_ss,
                            s.cfg["vocab_size"])
    tracer = None
    if trace:
        from bench import tracing
        tracing.warm()
        tracer = tracing.Tracer()
    if fault is not None:
        fault(s.eng)
    setup_s = clock() - t_start
    rec = open_loop(s, reqs, seconds, tracer, clock, events=trace)
    t_loop = clock()
    w0, w1 = rec.window
    e2e, counts = stats.end_to_end(
        rec.requests, w0, w1, rec.t_stop,
        stats.tokens_served(rec.prefills, rec.decodes, w0, w1))
    counts["steps_in_window"] = len(rec.in_window(rec.steps))
    counts["rounds_in_window"] = len(rec.in_window(rec.rounds))
    counts["resumed"] = sum(r["resumed"] > 0 for r in rec.requests)
    e2e["setup_s"] = setup_s
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": (torch.cuda.get_device_name(0)
                            if device == "cuda" else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                         if device == "cuda" else 0)}
    if tracer is not None:
        tracer.stop()
        rec.trace = tracer.read(w1)
        tr = rec.trace
        device_info["busy_s"] = tr.busy_within([(tr.t0, tr.t1)])
        device_info["window_s"] = tr.t1 - tr.t0
        if log is not None:
            log(f"[trace] clock alignment room {tracer.align_room_ns} ns, "
                f"traced from {tr.t0 - w0:.3f} s into the window, "
                f"{len(tr.kernels)} kernels, {len(tr.bmm_calls)} bmm calls")
    t_trace = clock()
    bad = forbidden_modules()
    if bad:
        raise SystemExit("loaded after the window: " + ", ".join(bad))

    # -------------------------------------------- metrics of this run
    spec = s.spec
    wanted = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in wanted:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        v = (load_metric(root, m["name"])(rec) if trace
             else e2e.get(m["name"]))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    breakdown = _breakdown(rec) if tracer is not None else None

    # ------------------------------------------ correctness, state freed
    done = [r for r in rec.requests if r["done"] and r["generated"] > 0]
    c = s.t["check"]
    sample = check.draw_sample(done, s.sample_rng, c["sample_tokens"],
                               c["sample_requests"])
    cfg, wseeds = s.cfg, s.wseeds
    rec.trace = None
    del s, tracer
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    cmp = check.compare(cfg, sample, wseeds, device, control=control,
                        root=root)
    t_ref = clock()
    if log is not None:
        log(f"[time] setup {setup_s:.1f} s, loop {t_loop - t_start - setup_s:.1f}"
            f" s, trace {t_trace - t_loop:.1f} s, reference "
            f"{t_ref - t_trace:.1f} s, total {t_ref - t_start:.1f} s")
    name = f"logit_gap_{c['number']}"
    checks = {name: {"value": cmp["program"][c["number"]],
                     "limit": c["limit"]},
              "checked_tokens": {"value": cmp["tokens"],
                                 "limit": c["min_checked_tokens"]}}
    correct = (checks[name]["value"] <= c["limit"]
               and cmp["tokens"] >= c["min_checked_tokens"])
    if c.get("min_resumed"):
        # a cell whose quotas move checks requests resumed after a
        # preemption (their re-prefill of prompt and generated tokens)
        checks["checked_resumed"] = {"value": cmp["resumed"],
                                     "limit": c["min_resumed"]}
        correct = correct and cmp["resumed"] >= c["min_resumed"]
    out = {"correct": bool(correct), "attempted": counts["due_in_window"],
           "failed": counts["unfinished"] + counts["cloud"],
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["samples"] = {**counts, "checked_requests": cmp["requests"],
                      "checked_resumed": cmp["resumed"],
                      "quota_slots_min": rec.quota_min(),
                      **({"events": len(rec.events),
                          "events_dropped": rec.events_dropped}
                         if rec.events is not None else {}),
                      "gaps": cmp["program"],
                      "more": {k: v for k, v in e2e.items()
                               if k not in metrics}}
    if control:
        out["control"] = cmp["control"]
    out["checks"] = checks
    return out


def _breakdown(rec: Record) -> dict:
    """The ten device operations that took most time in the window, and
    the device's idle time in it by what the host was doing."""
    tr = rec.trace
    per: dict[str, float] = {}
    for k in tr.kernels:
        if tr.t0 <= k.start < tr.t1:
            key = k.name if len(k.name) <= 96 else k.name[:93] + "..."
            per[key] = per.get(key, 0.0) + k.dur
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    calls = _Spans([(a, b, "prefill") for a, b, *_ in rec.prefills]
                   + [(a, b, "decode") for a, b, *_ in rec.decodes]
                   + [(a, b, "dyverse_round") for a, b in rec.rounds])
    steps = _Spans([(a, b, "engine_step_other") for a, b in rec.steps])
    gaps: dict[str, float] = {}
    busy = [iv for iv in tr.busy() if iv[1] > tr.t0 and iv[0] < tr.t1]
    edges = [tr.t0] + [x for iv in busy for x in iv] + [tr.t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, tr.t0), min(b, tr.t1)
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = calls.at(mid) or steps.at(mid) or "loop_between_steps"
        gaps[label] = gaps.get(label, 0.0) + (b - a)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}


class _Spans:
    """Labelled host spans, looked up by time."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def at(self, t: float) -> str | None:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.spans[i][0] <= t < self.spans[i][1]:
            return self.spans[i][2]
        return None
