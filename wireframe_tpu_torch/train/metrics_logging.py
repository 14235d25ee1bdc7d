"""The metric writer of the training loop.

Port of `wireframe_tpu/train/metrics_logging.py`: every row is kept in
`history` and, with a path, appended to a JSON-lines file
(`<checkpoint_dir>/train_metrics.jsonl` by convention), one object per
log point with the reference's metric names; with a wandb run (from
`maybe_wandb`), also logged there.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class MetricWriter:
    def __init__(self, jsonl_path: Optional[str] = None, wandb_run=None):
        self.history = []
        self.jsonl_path = jsonl_path
        self.wandb_run = wandb_run
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)),
                        exist_ok=True)

    def log(self, metrics: Dict[str, float]) -> None:
        self.history.append(dict(metrics))
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(metrics) + "\n")
        if self.wandb_run is not None:
            self.wandb_run.log(metrics)

    def close(self) -> None:
        if self.wandb_run is not None:
            self.wandb_run.finish()


def maybe_wandb(project: str = "Wireframe3D",
                config: Optional[dict] = None):
    """wandb.init if wandb is importable and WANDB_MODE != 'disabled';
    None otherwise."""
    if os.environ.get("WANDB_MODE", "") == "disabled":
        return None
    try:
        import wandb
        return wandb.init(project=project, config=config or {})
    except Exception as e:  # no wandb installed, or no network
        logger.info("wandb unavailable (%s); logging locally only", e)
        return None
