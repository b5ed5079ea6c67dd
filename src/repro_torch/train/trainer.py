"""Trainer: the train step in a loop over numpy batches, with
checkpoint/restart, the straggler monitor and preemption-safe shutdown
(SIGTERM), as the JAX package's Trainer; single device."""
from __future__ import annotations

import dataclasses
import signal
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer
from repro_torch.optim.adamw import OptimizerConfig
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
    else starts from ``state`` (e.g. ``from_numpy_state`` of a JAX one),
    or from ``init_state(cfg, seed)`` on ``device``."""

    def __init__(self, cfg: ModelConfig, ocfg: OptimizerConfig,
                 tcfg: TrainerConfig, seed: int = 0, device="cuda",
                 state: Optional[dict] = None):
        self.cfg, self.ocfg, self.tcfg = cfg, ocfg, tcfg
        self.monitor = StepTimeMonitor()
        self.metrics_log: list = []
        self._stop = False
        self._step = steps_lib.build_train_step(cfg, ocfg,
                                                loss_chunk=tcfg.loss_chunk)
        dev = (state["step"].device if state is not None
               else transformer.resolve_device(device))
        start = (checkpoint.latest_step(tcfg.ckpt_dir) if tcfg.ckpt_dir
                 else None)
        if start is not None:
            self.state = checkpoint.restore(tcfg.ckpt_dir, start, device=dev)
            self.start_step = int(start)
        else:
            self.state = (state if state is not None
                          else S.init_state(cfg, seed=seed, device=dev))
            self.start_step = int(self.state["step"])
        self.device = self.state["step"].device

        # preemption-safe: SIGTERM ends the run after the step in flight,
        # and the run's final checkpoint is written
        try:
            signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:      # not in the main thread
            pass

    def _on_sigterm(self, *_):
        self._stop = True

    def _save(self, step: int) -> None:
        if self.tcfg.ckpt_dir:
            checkpoint.save(self.state, step, self.tcfg.ckpt_dir,
                            keep=self.tcfg.keep_checkpoints)

    def run(self, data: Iterator[Dict[str, np.ndarray]],
            step_hook: Optional[Callable[[int, dict], None]] = None) -> dict:
        step = self.start_step
        for batch in data:
            if step >= self.tcfg.total_steps or self._stop:
                break
            batch = {k: torch.as_tensor(np.asarray(v), device=self.device)
                     for k, v in batch.items()}
            self.monitor.start()
            self.state, metrics = self._step(self.state, batch)
            # float() waits for the device: the step time holds its kernels
            metrics = {k: float(v) for k, v in metrics.items()}
            self.monitor.stop(step)
            step += 1
            if step % self.tcfg.log_interval == 0 or step == 1:
                self.metrics_log.append({"step": step, **metrics})
            if step_hook:
                step_hook(step, metrics)
            if self.tcfg.ckpt_dir and step % self.tcfg.ckpt_interval == 0:
                self._save(step)
            if self.monitor.should_act():
                # straggler density high: checkpoint eagerly so a scheduler
                # can replace the slow host with bounded lost work
                self._save(step)
                self.monitor.events.append(
                    {"step": step, "action": "eager_checkpoint"})
        self._save(step)
        return {"final_step": step,
                "metrics": self.metrics_log,
                "straggler": self.monitor.summary(),
                "interrupted": self._stop}
