"""Trainer: the train step in a loop over numpy batches, with a metrics
log and a step hook.  Single device; checkpoint/restart, SIGTERM handling
and the straggler monitor of the JAX Trainer are not ported yet."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import steps as steps_lib
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train import state as S


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None      # not ported: must stay None
    ckpt_interval: int = 50
    keep_checkpoints: int = 3
    log_interval: int = 10
    loss_chunk: int = 512


class Trainer:
    """state: a train state to start from (e.g. ``from_numpy_state`` of a
    JAX one); else ``init_state(cfg, seed)`` on ``device``."""

    def __init__(self, cfg: ModelConfig, ocfg: OptimizerConfig,
                 tcfg: TrainerConfig, seed: int = 0, device="cuda",
                 state: Optional[dict] = None):
        if tcfg.ckpt_dir:
            raise NotImplementedError("checkpointing is not ported")
        self.cfg, self.ocfg, self.tcfg = cfg, ocfg, tcfg
        self.metrics_log: list = []
        self._step = steps_lib.build_train_step(cfg, ocfg,
                                                loss_chunk=tcfg.loss_chunk)
        self.state = (state if state is not None
                      else S.init_state(cfg, seed=seed, device=device))
        self.device = self.state["step"].device
        self.start_step = int(self.state["step"])

    def run(self, data: Iterator[Dict[str, np.ndarray]],
            step_hook: Optional[Callable[[int, dict], None]] = None) -> dict:
        step = self.start_step
        for batch in data:
            if step >= self.tcfg.total_steps:
                break
            batch = {k: torch.as_tensor(np.asarray(v), device=self.device)
                     for k, v in batch.items()}
            self.state, metrics = self._step(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            step += 1
            if step % self.tcfg.log_interval == 0 or step == 1:
                self.metrics_log.append({"step": step, **metrics})
            if step_hook:
                step_hook(step, metrics)
        return {"final_step": step, "metrics": self.metrics_log}
