"""Trace export: Chrome-trace/Perfetto ``trace.json`` and JSONL event
logs from a ``TelemetryRecorder`` (the port's own copy of the JAX
package's ``serving/trace_export.py``; same events and schema check).

The Chrome trace event format (the JSON Perfetto's legacy importer and
chrome://tracing both load) is an object ``{"traceEvents": [...]}`` whose
events carry ``ph`` (phase), ``ts``/``dur`` (microseconds), ``pid``/
``tid`` lanes, and ``args``.  We emit:

  * pid 1 ("scheduler"): one "X" (complete) event per scheduler span
    (group formation, pressure preemption, prefill batch, decode chunk,
    drain) and "C" (counter) tracks for the per-iteration gauges (queue
    depth, active slots, free pages).
  * pid 2 ("requests"): one tid lane per request uid, an "i" (instant)
    event per lifecycle transition plus derived "X" spans for the queued
    wait (submit -> admit/reject/shed) and the generation phase (first
    token -> terminal event) so lanes read at a glance.

``validate_chrome_trace`` is the schema check the tests (and the chaos
CLI) run over the written file — it enforces the subset of the format we
rely on rather than trusting "it loaded once in Perfetto".
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from repro_torch.serving.telemetry import TelemetryRecorder

SCHED_PID = 1
REQ_PID = 2

# lifecycle events that end a request's lane
TERMINAL_EVENTS = ("retired", "shed", "rejected", "cancelled")


def _us(recorder: TelemetryRecorder, t: float) -> float:
    return max(0.0, (t - recorder.time_origin)) * 1e6


def chrome_trace(recorder: TelemetryRecorder) -> Dict[str, Any]:
    """Build the Chrome-trace object (host data only; json-serializable)."""
    ev: List[dict] = []
    ev.append({"ph": "M", "pid": SCHED_PID, "tid": 0,
               "name": "process_name", "args": {"name": "scheduler"}})
    ev.append({"ph": "M", "pid": REQ_PID, "tid": 0,
               "name": "process_name", "args": {"name": "requests"}})

    for sp in recorder.spans:
        ev.append({"ph": "X", "pid": SCHED_PID, "tid": 0, "name": sp.name,
                   "ts": _us(recorder, sp.t0),
                   "dur": max(0.0, (sp.t1 - sp.t0) * 1e6),
                   "args": {"iteration": sp.iteration, **sp.args}})
    for name, track in recorder.gauge_tracks.items():
        for t, v in track:
            ev.append({"ph": "C", "pid": SCHED_PID, "tid": 0, "name": name,
                       "ts": _us(recorder, t), "args": {"value": v}})

    for uid, timeline in sorted(recorder.timelines.items()):
        ev.append({"ph": "M", "pid": REQ_PID, "tid": uid,
                   "name": "thread_name", "args": {"name": f"req {uid}"}})
        submit_t: Optional[float] = None
        first_tok_t: Optional[float] = None
        for e in timeline:
            args = {k: v for k, v in e.items()
                    if k not in ("t", "uid", "event")}
            ev.append({"ph": "i", "pid": REQ_PID, "tid": uid,
                       "name": e["event"], "ts": _us(recorder, e["t"]),
                       "s": "t", "args": args})
            name, t = e["event"], e["t"]
            if name == "submit":
                submit_t = t
            elif name == "first_token":
                first_tok_t = t
            if submit_t is not None and (
                    name in ("admitted", "resumed") or
                    name in TERMINAL_EVENTS):
                ev.append({"ph": "X", "pid": REQ_PID, "tid": uid,
                           "name": "queued", "ts": _us(recorder, submit_t),
                           "dur": max(0.0, (t - submit_t) * 1e6),
                           "args": {}})
                submit_t = None
            if name == "preempted":
                submit_t = t                 # re-queued wait restarts
            if first_tok_t is not None and name in TERMINAL_EVENTS:
                ev.append({"ph": "X", "pid": REQ_PID, "tid": uid,
                           "name": "generate", "ts": _us(recorder,
                                                         first_tok_t),
                           "dur": max(0.0, (t - first_tok_t) * 1e6),
                           "args": {"finish": name}})
                first_tok_t = None
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def write_trace(recorder: TelemetryRecorder, path: str) -> Dict[str, Any]:
    trace = chrome_trace(recorder)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


def write_events_jsonl(recorder: TelemetryRecorder, path: str) -> int:
    """Append-free JSONL dump of the (bounded) global event log."""
    n = 0
    with open(path, "w") as f:
        for e in recorder.events:
            f.write(json.dumps(e) + "\n")
            n += 1
    return n


# ------------------------------------------------------------ validation
_ALLOWED_PH = {"X", "B", "E", "i", "I", "C", "M"}


def validate_chrome_trace(trace: Any) -> List[str]:
    """Check the subset of the Chrome trace event schema we emit.
    Returns a list of problems (empty = valid)."""
    errs: List[str] = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["top level must be an object with a traceEvents array"]
    evs = trace["traceEvents"]
    if not isinstance(evs, list):
        return ["traceEvents must be an array"]
    for i, e in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            errs.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in _ALLOWED_PH:
            errs.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(e.get("name"), str):
            errs.append(f"{where}: missing name")
        for key in ("pid", "tid"):
            if not isinstance(e.get(key), int):
                errs.append(f"{where}: missing integer {key}")
        if ph != "M":
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                errs.append(f"{where}: missing nonneg ts")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: X event missing nonneg dur")
        if ph == "C" and not isinstance(e.get("args"), dict):
            errs.append(f"{where}: C event missing args")
    return errs


def trace_uids(trace: Dict[str, Any]) -> set:
    """Every request uid with a lane in the trace (tid of pid-2 events)."""
    return {e["tid"] for e in trace.get("traceEvents", ())
            if e.get("pid") == REQ_PID and e.get("ph") != "M"}
