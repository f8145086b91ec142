"""TSP evaluation: the binary classification scores of the edge labels.

The JAX module (`egt_tpu/training/schemes/tsp.py:61-76`) takes accuracy,
precision, recall and F1 from scikit-learn; the port computes them in numpy
with scikit-learn's binary definitions (positive label 1): precision tp /
(tp + fp), recall tp / (tp + fn), F1 2 tp / (2 tp + fp + fn), each 0.0
where its denominator is 0 (no predicted, no true positives). The printed
lines are the JAX module's, letter for letter.
"""

from __future__ import annotations

import numpy as np


def _ratio(num: int, den: int) -> float:
    return num / den if den else 0.0


def scores(targets: np.ndarray, preds: np.ndarray) -> dict:
    """{accuracy, precision, recall, f1} of 0 / 1 labels."""
    t, p = targets == 1, preds == 1
    tp = int(np.count_nonzero(t & p))
    npred, ntrue = int(np.count_nonzero(p)), int(np.count_nonzero(t))
    return {"accuracy": float(np.mean(targets == preds)),
            "precision": _ratio(tp, npred), "recall": _ratio(tp, ntrue),
            "f1": _ratio(2 * tp, ntrue + npred)}


def tsp_lines(targets: np.ndarray, preds: np.ndarray) -> list[str]:
    s = scores(targets, preds)
    return [f"Accuracy = {s['accuracy']}", f"Precision = {s['precision']}",
            f"Recall = {s['recall']}", f"f1 = {s['f1']}"]


def evaluate(scheme, split: str) -> list[str]:
    """The lines of a split: its valid pairs (feature_matrix[..., 0] >= 0)
    through the scheme's `predict_split`, the class of the larger logit
    against the edge label."""
    targs, preds = [], []
    for batch, out in scheme.predict_split(split):
        valid = batch["feature_matrix"][..., 0].reshape(-1) >= 0
        targs.append(batch["target"].reshape(-1)[valid])
        preds.append(out.argmax(-1).reshape(-1)[valid])
    return tsp_lines(np.concatenate(targs), np.concatenate(preds))
