"""Trainer: the train step in a loop over numpy batches, with
checkpoint/restart, the straggler monitor and preemption-safe shutdown
(SIGTERM), as the JAX package's Trainer.

On one device, or under a mesh (``mesh``, ``rules``: launch/mesh.py,
``sharding.rules_for_mesh``) through the same code path: each step runs
under the rules, so the model takes the mesh's data and tensor
parallelism, and each rank takes its data rank's rows of the global
batches it is given.  Every rank holds only its part of the state
(train/state.storage_specs): it draws its parts from the seed
(``init_state(..., mesh=)``), keeps its slice of a whole state it is
given, and restores its slices of a checkpoint; a checkpoint is written
whole, each leaf gathered in turn and written by rank 0, between two
barriers.  A SIGTERM on any rank is agreed by an all-reduce of the stop
flag before each step, so every rank stops after the same step; the
metrics are the global batch's on every rank (launch/steps.py), and the
straggler monitor records the slowest rank's step time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import signal
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.data.pipeline import rank_rows
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.sharding import axis_rules, rules_for_mesh
from repro_torch.train import checkpoint
from repro_torch.train import state as S
from repro_torch.train.straggler import StepTimeMonitor


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_interval: int = 50
    keep_checkpoints: int = 3
    log_interval: int = 10
    loss_chunk: int = 512


class Trainer:
    """Resumes from the newest checkpoint in ``tcfg.ckpt_dir`` if there is
    one (onto ``state``'s device when a state is given, else ``device``);
    else starts from ``state`` (e.g. ``from_numpy_state`` of a JAX one;
    whole, or this rank's parts), or from ``init_state(cfg, seed)`` on
    ``device``.  Under ``mesh`` each rank keeps its parts."""

    def __init__(self, cfg: ModelConfig, ocfg: OptimizerConfig,
                 tcfg: TrainerConfig, seed: int = 0, device="cuda",
                 state: Optional[dict] = None, mesh=None, rules=None):
        self.cfg, self.ocfg, self.tcfg = cfg, ocfg, tcfg
        self.mesh = mesh
        self.rules = (rules_for_mesh(mesh) if rules is None and mesh
                      is not None else rules)
        self.world = (dist.get_world_size() if mesh is not None else 1)
        self.monitor = StepTimeMonitor()
        self.metrics_log: list = []
        self._stop = False
        self._step = steps_lib.build_train_step(cfg, ocfg,
                                                loss_chunk=tcfg.loss_chunk)
        dev = (S.state_device(state) if state is not None
               else transformer.resolve_device(device))
        start = (checkpoint.latest_step(tcfg.ckpt_dir) if tcfg.ckpt_dir
                 else None)
        self.specs = (S.storage_specs(cfg, self.rules) if mesh is not None
                      else None)
        self.stacked = S.stacked_leaves(cfg) if mesh is not None else None
        if start is not None:
            self.state = checkpoint.restore(tcfg.ckpt_dir, start, device=dev,
                                            specs=self.specs, mesh=mesh,
                                            stacked=self.stacked)
            self.start_step = int(start)
        elif state is not None:
            self.state = (state if mesh is None
                          else S.local_state(state, cfg, mesh))
            self.start_step = int(self.state["step"])
        else:
            self.state = S.init_state(cfg, seed=seed, device=dev, mesh=mesh)
            self.start_step = 0
        self.device = S.state_device(self.state)

        # preemption-safe: SIGTERM ends the run after the step in flight,
        # and the run's final checkpoint is written
        try:
            signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:      # not in the main thread
            pass

    def _on_sigterm(self, *_):
        self._stop = True

    def _rules(self):
        return (axis_rules(self.rules) if self.rules is not None
                else contextlib.nullcontext())

    def _agreed(self, value: float, op) -> float:
        """``value`` reduced by ``op`` over every rank (itself alone)."""
        if self.world == 1:
            return value
        t = torch.tensor(float(value), dtype=torch.float64,
                         device=self.device)
        dist.all_reduce(t, op=op)
        return float(t)

    def _save(self, step: int) -> None:
        if not self.tcfg.ckpt_dir:
            return
        if self.world > 1:
            dist.barrier()
        checkpoint.save(self.state, step, self.tcfg.ckpt_dir,
                        keep=self.tcfg.keep_checkpoints, specs=self.specs,
                        mesh=self.mesh, stacked=self.stacked)
        if self.world > 1:
            dist.barrier()

    def run(self, data: Iterator[Dict[str, np.ndarray]],
            step_hook: Optional[Callable[[int, dict], None]] = None) -> dict:
        """Steps over the global batches of ``data`` (every rank is given
        the same stream) until ``total_steps`` or an agreed stop."""
        step = self.start_step
        with self._rules():
            dp = C.batch_axis()
            for batch in data:
                stop = self._agreed(self._stop, dist.ReduceOp.MAX)
                if step >= self.tcfg.total_steps or stop:
                    self._stop = self._stop or bool(stop)
                    break
                if dp is not None:
                    batch = rank_rows(batch, dp.rank, dp.size)
                batch = {k: torch.as_tensor(np.asarray(v),
                                            device=self.device)
                         for k, v in batch.items()}
                t0 = time.perf_counter()
                self.state, metrics = self._step(self.state, batch)
                # float() waits for the device: the step time holds its
                # kernels
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = self._agreed(time.perf_counter() - t0,
                                  dist.ReduceOp.MAX)
                self.monitor.record(step, dt)
                step += 1
                if step % self.tcfg.log_interval == 0 or step == 1:
                    self.metrics_log.append({"step": step, **metrics})
                if step_hook:
                    step_hook(step, metrics)
                if self.tcfg.ckpt_dir and step % self.tcfg.ckpt_interval == 0:
                    self._save(step)
                if self.monitor.should_act():
                    # straggler density high: checkpoint eagerly so a
                    # scheduler can replace the slow host with bounded lost
                    # work
                    self._save(step)
                    self.monitor.events.append(
                        {"step": step, "action": "eager_checkpoint"})
        self._save(step)
        return {"final_step": step,
                "metrics": self.metrics_log,
                "straggler": self.monitor.summary(),
                "interrupted": self._stop}
