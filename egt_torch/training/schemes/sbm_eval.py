"""SBM (PATTERN / CLUSTER) evaluation.

Port of `egt_tpu/training/schemes/sbm_eval.py` (the reference eval mixins,
`lib/training/schemes/pattern/_eval.py:10-111`, `cluster/_eval.py:10-94`)
in numpy: the JAX module takes accuracy, recall and the confusion matrix from
scikit-learn, which the port does not need. Over the valid nodes of a split:
accuracy, micro and macro recall (sklearn's `recall_score`: the labels are
the sorted union of targets and predictions, and a label with no target
scores 0), the Dwivedi et al. class-balanced "SBM accuracy", and (PATTERN)
the class-weighted binary log loss. The printed lines are the JAX module's,
letter for letter.
"""

from __future__ import annotations

import numpy as np
import torch

from ..metrics import class_weights_from_sizes


def confusion_matrix(targets: np.ndarray, preds: np.ndarray) -> np.ndarray:
    """sklearn's `confusion_matrix`: rows the true label, columns the
    predicted one, over the sorted union of both."""
    labels = np.union1d(targets, preds)
    t = np.searchsorted(labels, targets)
    p = np.searchsorted(labels, preds)
    cm = np.zeros((len(labels), len(labels)), np.int64)
    np.add.at(cm, (t, p), 1)
    return cm


def accuracy(targets: np.ndarray, preds: np.ndarray) -> float:
    return float(np.mean(targets == preds))


def recall(targets: np.ndarray, preds: np.ndarray, average: str) -> float:
    """sklearn's `recall_score` with `average` "micro" or "macro"."""
    cm = confusion_matrix(targets, preds)
    tp, true = np.diag(cm), cm.sum(axis=1)
    if average == "micro":
        return float(tp.sum() / true.sum())
    per = np.divide(tp, true, out=np.zeros(len(tp)), where=true > 0)
    return float(np.mean(per))


def accuracy_sbm(targets: np.ndarray, preds: np.ndarray) -> float:
    cm = confusion_matrix(targets, preds).astype(np.float32)
    nb = cm.shape[0]
    pr = np.zeros(nb)
    for r in range(nb):
        cluster = np.where(targets == r)[0]
        pr[r] = cm[r, r] / float(cluster.shape[0]) if cluster.shape[0] else 0.0
    return float(pr.sum() / nb)


def weighted_log_loss(targs, preds, weights, eps=1e-9) -> float:
    sw = weights[targs.astype("int64")].astype("float32")
    t = np.clip(targs.astype("float32"), 0.0, 1.0)
    p = np.clip(preds.astype("float32"), eps, 1.0 - eps)
    losses = -(t * np.log(p) + (1 - t) * np.log(1 - p)) * sw
    return float(losses.mean())


def collect_node_predictions(scheme, split: str, prob_of_class1: bool):
    """(targets, class-1 probabilities or predicted classes) over the valid
    nodes (node_features >= 0) of a split, through the scheme's
    `predict_split`, concatenated across batches."""
    targs, preds = [], []
    for batch, out in scheme.predict_split(split):
        valid = batch["node_features"].reshape(-1) >= 0
        t = batch["target"].reshape(-1)[valid]
        probs = torch.softmax(torch.from_numpy(out), dim=-1).numpy()
        if prob_of_class1:
            p = probs[..., 1].reshape(-1)[valid]
        else:
            p = probs.argmax(-1).reshape(-1)[valid]
        targs.append(t)
        preds.append(p)
    return np.concatenate(targs), np.concatenate(preds)


def pattern_lines(targs, probs, class_sizes) -> list[str]:
    pred_class = np.round(probs).astype(targs.dtype)
    ll = weighted_log_loss(targs, probs, class_weights_from_sizes(class_sizes))
    return [
        f"Accuracy = {accuracy(targs, pred_class):0.5%}",
        f"Micro Recall = {recall(targs, pred_class, 'micro'):0.5%}",
        f"Macro Recall = {recall(targs, pred_class, 'macro'):0.5%}",
        f"Weighted Accuracy = {accuracy_sbm(targs, pred_class):0.5%}",
        f"Log loss:{ll:0.5f}",
    ]


def cluster_lines(targs, preds) -> list[str]:
    return [
        f"Accuracy = {accuracy(targs, preds):0.5%}",
        f"Micro Recall = {recall(targs, preds, 'micro'):0.5%}",
        f"Macro Recall = {recall(targs, preds, 'macro'):0.5%}",
        f"Weighted Accuracy = {accuracy_sbm(targs, preds):0.5%}",
    ]


def evaluate_pattern(scheme, split: str, class_sizes) -> list[str]:
    targs, probs = collect_node_predictions(scheme, split, prob_of_class1=True)
    return pattern_lines(targs, probs, class_sizes)


def evaluate_cluster(scheme, split: str) -> list[str]:
    targs, preds = collect_node_predictions(scheme, split, prob_of_class1=False)
    return cluster_lines(targs, preds)
