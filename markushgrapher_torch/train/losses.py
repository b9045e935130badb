"""Loss functions (port of `markushgrapher_tpu.train.losses`).

The default is CE with -100 masking (`models.markushgrapher.
cross_entropy_with_ignore`, the reference's `loss_fct: CE`); the huber
variants keep `loss_fct` a working knob."""

from __future__ import annotations

import torch


def huber_loss(pred: torch.Tensor, target: torch.Tensor,
               delta: float = 1.0) -> torch.Tensor:
    abs_err = (pred - target).abs()
    quad = abs_err.clamp(max=delta)
    return (0.5 * quad ** 2 + delta * (abs_err - quad)).mean()


def _target_prob(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_index: int):
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    p = torch.softmax(logits.to(torch.float32), dim=-1)
    return valid, torch.gather(p, -1, safe[..., None])[..., 0]


def custom_huber(logits: torch.Tensor, labels: torch.Tensor,
                 delta: float = 1.0, ignore_index: int = -100
                 ) -> torch.Tensor:
    """Huber on the softmax probability of the target class (penalise the
    distance of p(target) from 1), mean over valid tokens."""
    valid, p_target = _target_prob(logits, labels, ignore_index)
    err = torch.where(valid, 1.0 - p_target, 0.0)
    quad = err.clamp(max=delta)
    per_tok = 0.5 * quad ** 2 + delta * (err - quad)
    return per_tok.sum() / valid.sum().clamp(min=1)


def custom_huber2(logits: torch.Tensor, labels: torch.Tensor,
                  delta: float = 1.0, ignore_index: int = -100,
                  eps: float = 1e-6) -> torch.Tensor:
    """The reference's log-threshold variant on err = 1 - p(target): |err|
    where log(|err| + eps) < delta, else delta * (log|err| - log(delta) +
    1); mean over valid tokens / 5."""
    valid, p_target = _target_prob(logits, labels, ignore_index)
    err = torch.where(valid, 1.0 - p_target, 0.0).abs()
    ln_loss = torch.log(err + eps)
    log_delta = torch.log(torch.tensor(delta, dtype=torch.float32))
    per_tok = torch.where(ln_loss < delta, err,
                          delta * (ln_loss - log_delta + 1.0))
    per_tok = torch.where(valid, per_tok, 0.0)
    return per_tok.sum() / valid.sum().clamp(min=1) / 5.0


def get_loss_fn(name: str):
    from markushgrapher_torch.models.markushgrapher import (
        cross_entropy_with_ignore)

    return {
        "CE": cross_entropy_with_ignore,
        "huber": custom_huber,
        "huber2": custom_huber2,
    }[name]
