"""Straggler mitigation: per-step timing statistics with outlier policy
(the JAX package's module, copied: it is pure Python).

At 1000+ nodes the common failure mode is not crashes but *slow* hosts
(thermal throttling, flaky interconnect links, noisy neighbors).  The
monitor keeps a rolling window of step times; a step whose z-score
exceeds the threshold increments a per-run straggle counter, and
`should_act()` fires when the recent straggle density crosses the action
threshold — the trainer responds by (a) emitting an ops event and (b)
checkpointing eagerly so a scheduler can evict/replace the slow host with
bounded lost work.  (Synchronous SPMD means one slow host drags the whole
step — detection is global by construction, so any host's timeline
identifies the event.)
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import Deque, List, Optional


@dataclasses.dataclass
class StragglerConfig:
    window: int = 50
    z_threshold: float = 3.0
    min_samples: int = 10
    act_density: float = 0.2     # fraction of recent steps flagged -> act


class StepTimeMonitor:
    def __init__(self, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.times: Deque[float] = collections.deque(maxlen=cfg.window)
        self.flags: Deque[bool] = collections.deque(maxlen=cfg.window)
        self.events: List[dict] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> float:
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.record(step, dt)
        return dt

    def record(self, step: int, dt: float) -> bool:
        flagged = False
        if len(self.times) >= self.cfg.min_samples:
            med = statistics.median(self.times)
            mad = statistics.median(abs(t - med) for t in self.times)
            sd = 1.4826 * mad + 1e-9      # robust sigma: outliers already in
            z = (dt - med) / sd           # the window cannot mask new ones
            if z > self.cfg.z_threshold:
                flagged = True
                self.events.append({"step": step, "dt": dt, "z": z})
        self.times.append(dt)
        self.flags.append(flagged)
        return flagged

    def should_act(self) -> bool:
        if len(self.flags) < self.cfg.min_samples:
            return False
        return (sum(self.flags) / len(self.flags)) >= self.cfg.act_density

    def summary(self) -> dict:
        return {
            "steps": len(self.times),
            "mean_s": statistics.fmean(self.times) if self.times else 0.0,
            "flagged": sum(self.flags),
            "events": self.events[-5:],
        }
