"""Pluggable experiment-tracker backends behind the `report_to` knob.

The reference optionally wires ClearML at train startup
(DS4SD/MarkushGrapher:markushgrapher/train.py:68-78: `Task.init` when
`report_to` is "clearml" and the import succeeded, task name =
clearml_task_name + timestamp) and hands the task to the trainer. The
rebuild keeps the same contract with a small protocol so the training
loop stays backend-agnostic:

- ``report_to: none``   -> NoopTracker (the reference default)
- ``report_to: jsonl``  -> JsonlTracker (append-only metrics stream,
  one JSON object per event — the native observability path)
- ``report_to: clearml``-> ClearmlTracker when the `clearml` package is
  importable, else a warning + Noop (mirrors the reference's
  `Task is not None` guard; clearml is not in this image)

Trackers receive every log_history event (train scalars and eval
metrics) via :meth:`log_scalars`, plus one :meth:`connect` call with the
flattened run configuration (the reference's `task.connect(args)`).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


class NoopTracker:
    """Default backend: no external reporting (reference `report_to: none`)."""

    def connect(self, config: Dict[str, Any]) -> None:  # noqa: D401
        pass

    def log_scalars(self, step: int, scalars: Dict[str, Any]) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlTracker(NoopTracker):
    """Append-only JSONL stream, one object per event.

    Unlike train_main's end-of-run metrics.jsonl dump, this writes
    *during* training, so a killed run still leaves its curve on disk.
    """

    def __init__(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def connect(self, config: Dict[str, Any]) -> None:
        self._f.write(json.dumps({"event": "config", **_plain(config)},
                                 default=str) + "\n")

    def log_scalars(self, step: int, scalars: Dict[str, Any]) -> None:
        self._f.write(json.dumps({"step": step, **_plain(scalars)},
                                 default=str) + "\n")

    def close(self) -> None:
        self._f.close()


class ClearmlTracker(NoopTracker):
    """ClearML backend (reference train.py:70-78). Requires `clearml`."""

    def __init__(self, task_name: Optional[str] = None,
                 project_name: str = "MarkushGrapher-TPU") -> None:
        from clearml import Task  # raises ImportError when absent

        stamp = datetime.datetime.now().strftime("%I_%M_%p_%B_%d_%Y")
        self.task = Task.init(project_name=project_name,
                              task_name=(task_name or "train") + stamp)

    def connect(self, config: Dict[str, Any]) -> None:
        self.task.connect(_plain(config))

    def log_scalars(self, step: int, scalars: Dict[str, Any]) -> None:
        log = self.task.get_logger()
        for k, v in scalars.items():
            if isinstance(v, (int, float)):
                log.report_scalar(title=k, series=k, value=float(v),
                                  iteration=step)

    def close(self) -> None:
        self.task.close()


def _plain(d: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        if isinstance(v, (int, float, str, bool, type(None))):
            out[k] = v
        else:
            out[k] = str(v)
    return out


def make_tracker(report_to: str, output_dir: str = ".",
                 task_name: Optional[str] = None):
    """Build the tracker for `report_to`; never raises on a missing
    backend (the reference degrades to None when clearml won't import)."""
    name = (report_to or "none").strip().lower()
    if name in ("none", "", "[]"):
        return NoopTracker()
    if name == "jsonl":
        return JsonlTracker(os.path.join(output_dir, "tracker.jsonl"))
    if name == "clearml":
        try:
            return ClearmlTracker(task_name=task_name)
        except ImportError:
            logger.warning(
                "report_to=clearml but the clearml package is not "
                "installed; continuing without a tracker")
            return NoopTracker()
    logger.warning("unknown report_to=%r; continuing without a tracker",
                   report_to)
    return NoopTracker()
