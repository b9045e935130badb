"""Checkpointing with `torch.save` (port of
`markushgrapher_tpu.train.checkpoint`, which uses orbax): step checkpoints
`checkpoint-{step}/state` with `save_total_limit` rotation and resume from
the last one, per-submodule weight export / import, and weight fingerprints.

A state file holds {"step", "params" (the model's state_dict), "opt" (the
optimizer state)}; `restore` loads one into a live `TrainState`,
`restore_params` returns the params alone (serving, or a different
optimizer setup).
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")


def last_checkpoint(output_dir: str) -> Optional[str]:
    """The checkpoint-N directory with the largest N, or None."""
    if not os.path.isdir(output_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(output_dir):
        m = _CKPT_RE.match(name)
        if m and os.path.isdir(os.path.join(output_dir, name)):
            step = int(m.group(1))
            if step > best_step:
                best, best_step = os.path.join(output_dir, name), step
    return best


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


class Checkpointer:
    """Step checkpoints of a TrainState with rotation."""

    def __init__(self, output_dir: str, save_total_limit: int = 10):
        self.output_dir = os.path.abspath(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)
        self.save_total_limit = save_total_limit

    def save(self, step: int, state: Any) -> str:
        path = os.path.join(self.output_dir, f"checkpoint-{step}")
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, "state.tmp")
        torch.save({"step": int(state.step),
                    "params": _cpu(state.params.state_dict()),
                    "opt": _cpu(state.opt.state_dict())}, tmp)
        os.replace(tmp, os.path.join(path, "state"))
        self._rotate()
        logger.info("saved checkpoint %s", path)
        return path

    def restore(self, path: str, state: Any) -> Any:
        """Load checkpoint `path` into `state` (params, optimizer state and
        step, on the state's device); returns it."""
        saved = torch.load(os.path.join(path, "state"), map_location="cpu",
                           weights_only=True)
        state.params.load_state_dict(saved["params"])
        state.opt.load_state_dict(saved["opt"])
        state.step = int(saved["step"])
        return state

    def restore_params(self, path: str) -> Dict[str, torch.Tensor]:
        """Params-only restore: the saved state_dict."""
        return torch.load(os.path.join(path, "state"), map_location="cpu",
                          weights_only=True)["params"]

    def _rotate(self) -> None:
        ckpts = []
        for name in os.listdir(self.output_dir):
            m = _CKPT_RE.match(name)
            if m:
                ckpts.append((int(m.group(1)), name))
        ckpts.sort()
        while len(ckpts) > self.save_total_limit:
            _, name = ckpts.pop(0)
            shutil.rmtree(os.path.join(self.output_dir, name),
                          ignore_errors=True)
            logger.info("rotated out old checkpoint %s", name)


# -- submodule export / import ---------------------------------------------------

SUBMODULES = ("molscribe_encoder", "molscribe_projector", "encoder", "decoder",
              "lm_head", "shared_embedding")


def _submodule(params: Mapping[str, torch.Tensor], name: str
               ) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in params.items()
            if k == name or k.startswith(name + ".")}


def save_weights_separately(params: Mapping[str, torch.Tensor],
                            output_dir: str,
                            submodules: Optional[List[str]] = None
                            ) -> List[str]:
    """Export each top-level submodule of a state_dict as its own file
    `{name}.pt` (the reference's two-phase training recipe)."""
    os.makedirs(output_dir, exist_ok=True)
    written = []
    for name in (submodules or SUBMODULES):
        part = _submodule(params, name)
        if not part:
            continue
        path = os.path.join(output_dir, f"{name}.pt")
        torch.save(_cpu(part), path)
        written.append(path)
        logger.info("exported %s", path)
    return written


def load_submodule_weights(params: Dict[str, torch.Tensor], name: str,
                           path: str) -> Dict[str, torch.Tensor]:
    """Replace submodule `name` of a state_dict from a file written by
    save_weights_separately; missing or extra tensors and shape mismatches
    raise with the offending names listed."""
    target = _submodule(params, name)
    if not target:
        raise KeyError(f"model has no submodule {name!r}; has "
                       f"{sorted({k.split('.')[0] for k in params})}")
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    if set(loaded) != set(target):
        raise ValueError(f"tensor names differ loading {name}: missing "
                         f"{sorted(set(target) - set(loaded))}, extra "
                         f"{sorted(set(loaded) - set(target))}")
    mismatches = [(k, tuple(target[k].shape), tuple(loaded[k].shape))
                  for k in target if target[k].shape != loaded[k].shape]
    if mismatches:
        raise ValueError(f"shape mismatches loading {name}: {mismatches}")
    for k, v in loaded.items():
        params[k] = v.to(device=target[k].device, dtype=target[k].dtype)
    return params


# -- fingerprints ---------------------------------------------------------------

def compute_weight_stats(params: Mapping[str, torch.Tensor]
                         ) -> Dict[str, Any]:
    """Checksum-style fingerprints: parameter count, sums of the first and
    last 1000 values (state_dict order), per-tensor sums (float64)."""
    per_tensor = {}
    total = 0
    flat_parts = []
    for key, leaf in params.items():
        arr = leaf.detach().to(torch.float64).cpu().numpy()
        per_tensor[key] = float(arr.sum())
        total += arr.size
        flat_parts.append(arr.reshape(-1))
    flat = np.concatenate(flat_parts) if flat_parts else np.zeros(0)
    return {
        "num_params": int(total),
        "first_1000_sum": float(flat[:1000].sum()),
        "last_1000_sum": float(flat[-1000:].sum()),
        "per_tensor_sums": per_tensor,
    }


def compare_module_weights(params: Mapping[str, torch.Tensor],
                           reference_json: str,
                           atol: float = 1e-4) -> List[str]:
    """Compare fingerprints against a stored JSON; returns the mismatches."""
    with open(reference_json) as f:
        ref = json.load(f)
    cur = compute_weight_stats(params)
    problems = []
    if cur["num_params"] != ref.get("num_params"):
        problems.append(
            f"num_params {cur['num_params']} != {ref.get('num_params')}")
    for key in ("first_1000_sum", "last_1000_sum"):
        if abs(cur[key] - ref.get(key, 0.0)) > atol:
            problems.append(f"{key} {cur[key]} != {ref.get(key)}")
    for name, s in ref.get("per_tensor_sums", {}).items():
        c = cur["per_tensor_sums"].get(name)
        if c is None:
            problems.append(f"missing tensor {name}")
        elif abs(c - s) > atol:
            problems.append(f"tensor {name} sum {c} != {s}")
    return problems
