"""The metric writer of the training loop.

Port of `wireframe_tpu/train/metrics_logging.py:MetricWriter` without its
wandb sink: every row is kept in `history` and, with a path, appended to
a JSON-lines file (`<checkpoint_dir>/train_metrics.jsonl` by convention),
one object per log point with the reference's metric names.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional


class MetricWriter:
    def __init__(self, jsonl_path: Optional[str] = None):
        self.history = []
        self.jsonl_path = jsonl_path
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)),
                        exist_ok=True)

    def log(self, metrics: Dict[str, float]) -> None:
        self.history.append(dict(metrics))
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(metrics) + "\n")
