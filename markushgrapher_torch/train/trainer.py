"""Training runtime (port of `markushgrapher_tpu.train.trainer`) on one
device.

`Trainer.train_step` runs the model's teacher-forced forward with dropout
(deterministic=False), CE with -100 masking (or the `loss_fct` override),
backward, and one `train.optim.AdamW` call; the logged `grad_norm` is the
global norm of every gradient, frozen parameters included, as the
reference's `optax.global_norm(grads)`. Compute dtype from
`TrainConfig.dtype`: "bfloat16" runs the matmuls under bf16 autocast over
the float32 master parameters (the only dtype the CUDA flash kernels take);
"float32" runs everything in float32. The state's step counts train_step
calls (micro-batches, as the reference's `state.step`) and is the host's
own integer: a resumed run continues at the saved step, and `train` stops
at `max_steps`. `CurriculumCallback` is the reference's eval-loss plateau
trigger. Sharding (ZeRO, the model axis) is not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from markushgrapher_torch.config import TrainConfig
from markushgrapher_torch.models.markushgrapher import MarkushGrapherModel
from markushgrapher_torch.train.losses import get_loss_fn
from markushgrapher_torch.train.optim import AdamW, global_norm

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    """step: train_step calls so far; params: the model (its parameters are
    the float32 master weights); opt: the optimizer with its state."""

    step: int
    params: MarkushGrapherModel
    opt: AdamW


def to_device(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items() if v is not None}


def step_generator(seed: int, step: int) -> torch.Generator:
    """The dropout generator of one step (the reference folds the step into
    its rng the same way: one stream per step)."""
    return torch.Generator().manual_seed(
        (int(seed) * 1_000_003 + int(step)) % (2 ** 63))


@dataclasses.dataclass
class Trainer:
    """Host-side orchestration around train_step. The data source is any
    iterator of numpy batches with input_ids / bbox / attention_mask /
    labels (+ pixel inputs); `data.dataset.MultitaskIterator` samples
    several datasets."""

    model: MarkushGrapherModel
    cfg: TrainConfig
    frozen_prefixes: tuple = ()
    eval_fn: Optional[Callable[[Any, int], Dict[str, float]]] = None
    # best-checkpoint selection (reference: metric_for_best_model with
    # load_best_model_at_end)
    metric_for_best_model: Optional[str] = None
    greater_is_better: bool = True
    # called with the new level when the curriculum callback escalates
    on_curriculum_level: Optional[Callable[[int], None]] = None
    # experiment tracker (utils/tracker.make_tracker)
    tracker: Optional[Any] = None

    def __post_init__(self):
        if self.cfg.dtype not in ("bfloat16", "float32"):
            raise ValueError(f"TrainConfig.dtype {self.cfg.dtype!r}")
        self.model.remat = self.cfg.remat
        self.log_history = []
        self.best_metric: Optional[float] = None
        self.best_step: Optional[int] = None
        loss_name = getattr(self.cfg, "loss_fct", "CE") or "CE"
        self._loss_override = (get_loss_fn(loss_name) if loss_name != "CE"
                               else None)

    @property
    def device(self) -> torch.device:
        return self.model.shared_embedding.device

    # -- initialization -----------------------------------------------------

    def init_state(self, seed: Optional[int] = None,
                   params: Optional[Dict[str, torch.Tensor]] = None
                   ) -> TrainState:
        """Seeded init of the model's float32 parameters (or `params`, a
        state_dict), and a fresh optimizer state."""
        self.model.to(torch.float32)
        if params is None:
            self.model.init_weights(self.cfg.seed if seed is None else seed)
        else:
            self.model.load_state_dict(params)
        opt = AdamW(self.model.named_parameters(), self.cfg,
                    self.frozen_prefixes)
        return TrainState(step=0, params=self.model, opt=opt)

    # -- the step ------------------------------------------------------------

    def train_step(self, state: TrainState, batch: Dict[str, Any],
                   seed: int = 0):
        """One micro-batch: training forward (dropout from the step's
        generator), backward, one optimizer call. Returns (state, {"loss",
        "grad_norm"}) with the metrics as device scalars (no host sync)."""
        batch = to_device(batch, self.device)
        model = state.params
        model.train()
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.cfg.dtype == "bfloat16"):
            out = model(**batch, deterministic=False,
                        generator=step_generator(seed, state.step))
            if self._loss_override is not None:
                loss = self._loss_override(out["logits"], batch["labels"])
            else:
                loss = out["loss"]
        model.zero_grad(set_to_none=True)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in model.named_parameters()}
        gnorm = global_norm(grads.values())
        state.opt.step(grads)
        model.zero_grad(set_to_none=True)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    # -- the loop -------------------------------------------------------------

    def train(self, state: TrainState, data_iter: Iterator[Dict[str, Any]],
              seed: int = 0, max_steps: Optional[int] = None,
              log_every: int = 50, checkpointer: Optional[Any] = None
              ) -> TrainState:
        max_steps = max_steps or self.cfg.max_steps
        t0 = time.time()
        curriculum = (CurriculumCallback(self.cfg) if self.cfg.curriculum
                      else None)
        for batch in data_iter:
            if state.step >= max_steps:
                break
            state, metrics = self.train_step(state, batch, seed)
            step = state.step
            if step % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step, steps_per_sec=log_every / max(
                    time.time() - t0, 1e-9))
                t0 = time.time()
                self.log_history.append(m)
                if self.tracker is not None:
                    self.tracker.log_scalars(step, m)
                logger.info("step %d: %s", step, m)
            if self.eval_fn and step % self.cfg.eval_steps == 0:
                eval_metrics = self.eval_fn(state, step)
                self.log_history.append(dict(eval_metrics, step=step))
                if self.tracker is not None:
                    self.tracker.log_scalars(step, eval_metrics)
                if curriculum:
                    prev = curriculum.level
                    level = curriculum.update(eval_metrics.get("eval_loss"))
                    if level != prev and self.on_curriculum_level:
                        self.on_curriculum_level(level)
                self._track_best(eval_metrics, step, state, checkpointer)
            if checkpointer and step % self.cfg.save_steps == 0:
                checkpointer.save(step, state)
        return state

    def _track_best(self, metrics: Dict[str, float], step: int, state,
                    checkpointer) -> None:
        if not self.metric_for_best_model:
            return
        value = metrics.get(self.metric_for_best_model)
        if value is None:
            return
        better = (self.best_metric is None
                  or (value > self.best_metric) == self.greater_is_better
                  and value != self.best_metric)
        if better:
            self.best_metric, self.best_step = float(value), step
            logger.info("new best %s=%.4f at step %d",
                        self.metric_for_best_model, value, step)
            if checkpointer:
                path = checkpointer.save(step, state)
                marker = os.path.join(checkpointer.output_dir,
                                      "best_checkpoint.txt")
                with open(marker, "w") as f:
                    f.write(f"{path}\n{self.metric_for_best_model}="
                            f"{self.best_metric}\n")


class CurriculumCallback:
    """Eval-loss plateau trigger (the reference's `elevateMRCallback`): when
    eval loss stops improving for `patience` evals, raise the task
    difficulty (`.level`)."""

    def __init__(self, cfg: TrainConfig):
        self.patience = cfg.curriculum_patience
        self.threshold = cfg.curriculum_threshold
        self.best = float("inf")
        self.bad_evals = 0
        self.level = 0

    def update(self, eval_loss: Optional[float]) -> int:
        if eval_loss is None:
            return self.level
        if eval_loss < self.best - self.threshold:
            self.best = eval_loss
            self.bad_evals = 0
        else:
            self.bad_evals += 1
            if self.bad_evals >= self.patience:
                self.level += 1
                self.bad_evals = 0
                self.best = float("inf")
                logger.info("curriculum: raising difficulty to level %d",
                            self.level)
        return self.level
