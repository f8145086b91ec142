"""Timestamped JSON results records.

The port's own copy of `egt_tpu/training/results.py` (the JAX package is
not imported): the same fields, file name and layout. Equivalent of the
reference's results appender (`lib/training/schemes/evaluation.py:5-35`,
whose call sites are commented out there): appends one JSON file per evaluation with the
metrics, resolved config and training state, under <parent_dir>/results/.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


def save_results(dataset_name: str, model_name: str, split: str, metrics: dict,
                 configs: dict | None = None, state: dict | None = None,
                 parent_dir: str = "predictions") -> str:
    stamp = time.strftime("%Y%m%d-%H%M%S")
    out_dir = Path(parent_dir) / "results"
    out_dir.mkdir(parents=True, exist_ok=True)
    record = {
        "timestamp": stamp,
        "dataset_name": dataset_name,
        "model_name": model_name,
        "split": split,
        "metrics": metrics,
        "configs": configs or {},
        "state": {k: v for k, v in (state or {}).items()
                  if isinstance(v, (int, float, str))},
    }
    path = out_dir / f"{dataset_name}_{model_name}_{split}_{stamp}.json"
    with open(path, "w") as fp:
        json.dump(record, fp, indent=2)
    return str(path)
