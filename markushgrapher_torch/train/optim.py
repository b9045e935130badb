"""Optimizer and learning-rate schedules (port of
`markushgrapher_tpu.train.optim`).

The schedules compute in float32 as the reference's jnp versions do (HF
`inverse_sqrt`, and `linear_with_fact`: linear warm-up, then linear decay to
0, times `fact`). `AdamW` applies, step for step, the update of the
reference's optax chain:

    multi_transform({"train": MultiSteps(chain(clip_by_global_norm,
                                               adamw(schedule))),
                     "frozen": set_to_zero}, freeze_mask)

- `gradient_accumulation_steps` k > 1 keeps the running mean of k
  micro-batch gradients (Welford, as optax.MultiSteps) and updates the
  parameters on every k-th call only; the schedule advances once per real
  update;
- the clip norm is the global norm of the trainable gradients: t is kept
  below `max_grad_norm`, else replaced by (t / norm) * max_grad_norm;
- AdamW: mu, nu moments, bias-corrected, mu_hat / (sqrt(nu_hat) + eps) (eps
  outside the sqrt), plus the decoupled decay weight_decay * p, times
  -lr(count);
- frozen parameters (names under `frozen_prefixes`) are never touched:
  their values stay bit-unchanged and they have no optimizer state.

The update runs in place on the parameters with `torch._foreach_*` ops and
reads nothing back to the host.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from markushgrapher_torch.config import TrainConfig


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def inverse_sqrt_schedule(base_lr: float, warmup_steps: int
                          ) -> Callable[[int], float]:
    """HF inverse_sqrt: linear warm-up to base_lr, then
    base_lr * sqrt(warmup / step)."""
    warmup = max(1, warmup_steps)

    def schedule(step: int) -> float:
        s = torch.tensor(max(step, 1), dtype=torch.int32)
        warm = _f32(base_lr) * s / warmup
        decay = _f32(base_lr) * torch.sqrt(warmup / s)
        return float(torch.where(s < warmup, warm, decay))

    return schedule


def linear_with_fact_schedule(base_lr: float, warmup_steps: int,
                              total_steps: int, fact: float = 1.0
                              ) -> Callable[[int], float]:
    """Linear warm-up, then linear decay to 0, all scaled by `fact`."""
    warmup = max(1, warmup_steps)
    denom = max(1, total_steps - warmup_steps)

    def schedule(step: int) -> float:
        s = torch.tensor(step, dtype=torch.int32)
        warm = _f32(fact * base_lr) * s / warmup
        decay = _f32(fact * base_lr) * torch.clamp(
            (total_steps - s) / denom, min=0.0)
        return float(torch.where(s < warmup_steps, warm, decay))

    return schedule


def make_schedule(cfg: TrainConfig, total_steps: Optional[int] = None
                  ) -> Callable[[int], float]:
    total = total_steps or cfg.max_steps
    if cfg.lr_schedule == "inverse_sqrt":
        return inverse_sqrt_schedule(cfg.learning_rate, cfg.warmup_steps)
    if cfg.lr_schedule in ("linear_with_fact", "linear"):
        return linear_with_fact_schedule(cfg.learning_rate, cfg.warmup_steps,
                                         total)
    if cfg.lr_schedule == "constant":
        return lambda step: float(_f32(cfg.learning_rate))
    raise ValueError(f"unknown lr schedule {cfg.lr_schedule!r}")


def is_frozen(name: str, frozen_prefixes: Sequence[Sequence[str]]) -> bool:
    """A parameter is frozen when some prefix (a tuple of module names, e.g.
    ("molscribe_encoder",)) occurs in its dotted name as consecutive parts
    (the reference's freeze_mask matches anywhere below `params`)."""
    parts = name.split(".")
    for prefix in frozen_prefixes:
        prefix = tuple(prefix)
        for i in range(len(parts) - len(prefix) + 1):
            if tuple(parts[i:i + len(prefix)]) == prefix:
                return True
    return False


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (optax.global_norm), as a
    float32 device scalar."""
    tensors = list(tensors)
    norms = torch._foreach_norm([t.to(torch.float32) for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamW:
    """clip_by_global_norm -> adamw (-> MultiSteps) -> freeze mask; see the
    module docstring. `params` are (name, parameter) pairs, float32 master
    weights updated in place."""

    def __init__(self, params: Iterable[Tuple[str, torch.nn.Parameter]],
                 cfg: TrainConfig, frozen_prefixes: Sequence = (),
                 total_steps: Optional[int] = None):
        self.cfg = cfg
        self.schedule = make_schedule(cfg, total_steps)
        self.names: List[str] = []
        self.params: List[torch.nn.Parameter] = []
        for name, p in params:
            if not is_frozen(name, frozen_prefixes):
                self.names.append(name)
                self.params.append(p)
        self.state = self.init_state()

    def init_state(self) -> Dict:
        zeros = lambda: {n: torch.zeros_like(p)  # noqa: E731
                         for n, p in zip(self.names, self.params)}
        state = {"count": 0, "mini_step": 0, "mu": zeros(), "nu": zeros()}
        if self.cfg.gradient_accumulation_steps > 1:
            state["acc"] = zeros()
        return state

    def state_dict(self) -> Dict:
        return self.state

    def load_state_dict(self, state: Dict) -> None:
        for key in ("mu", "nu", "acc"):
            if key in self.state:
                for n in self.names:
                    self.state[key][n].copy_(state[key][n])
        self.state["count"] = int(state["count"])
        self.state["mini_step"] = int(state["mini_step"])

    def _moments(self, key: str) -> List[torch.Tensor]:
        return [self.state[key][n] for n in self.names]

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> bool:
        """One call per micro-batch with every parameter's gradient by name
        (frozen ones are ignored). Returns True when the parameters were
        updated (every k-th call under accumulation)."""
        cfg, state = self.cfg, self.state
        k = cfg.gradient_accumulation_steps
        # a copy when k == 1: the clip scales it in place
        g = [grads[n].to(torch.float32, copy=k == 1) for n in self.names]
        if k > 1:
            acc = self._moments("acc")
            n_acc = state["mini_step"]
            delta = torch._foreach_sub(g, acc)
            torch._foreach_div_(delta, float(n_acc + 1))
            torch._foreach_add_(acc, delta)
            if n_acc < k - 1:
                state["mini_step"] = n_acc + 1
                return False
            g = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
            state["mini_step"] = 0
        # clip_by_global_norm over the trainable gradients
        norm = global_norm(g)
        keep = norm < cfg.max_grad_norm
        one = torch.ones((), dtype=torch.float32, device=norm.device)
        torch._foreach_div_(g, torch.where(keep, one, norm))
        torch._foreach_mul_(g, torch.where(keep, one, one * cfg.max_grad_norm))
        # adamw
        b1, b2 = cfg.adam_b1, cfg.adam_b2
        state["count"] += 1
        count = state["count"]
        mu, nu = self._moments("mu"), self._moments("nu")
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        bc1 = float(1.0 - _f32(b1) ** count)
        bc2 = float(1.0 - _f32(b2) ** count)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.adam_eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        if cfg.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=cfg.weight_decay)
        torch._foreach_add_(self.params, upd,
                            alpha=-self.schedule(count - 1))
        return True
