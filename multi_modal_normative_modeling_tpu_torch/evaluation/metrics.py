"""Deviation-to-classification metrics.

Re-implements multimodal_kfold_cvae_group_analysis_1x1.py:39-157: ROC/AUC on
the scalar deviation score, Youden-J optimal thresholding (plus the f1 / pr /
cost / eer threshold finders), accuracy, sensitivity, specificity, and the
significance ratio AUC/(1-AUC).

The JAX package's module of the same name takes its curves and scores from
``sklearn.metrics``. This one computes them in numpy, value for value as
scikit-learn does (tests/test_torch_evaluation.py holds each to
scikit-learn's on the same arrays): the analysis stage runs where
scikit-learn is not installed.
"""
from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np


# ---- what the JAX package takes from sklearn.metrics ------------------------

def _column(values, name: str) -> np.ndarray:
    arr = np.asarray(values)
    if arr.ndim == 2 and arr.shape[1] == 1:
        arr = arr[:, 0]
    if arr.ndim != 1:
        raise ValueError(f'{name} must be one-dimensional, got shape '
                         f'{arr.shape}')
    return arr


def _binary_clf_curve(y_true, y_score):
    """(fps, tps, thresholds): false and true positives counted at every
    distinct score, scores descending; the positive label is 1."""
    y_true = _column(y_true, 'y_true')
    y_score = _column(y_score, 'y_score')
    if y_true.shape[0] != y_score.shape[0]:
        raise ValueError(f'{y_true.shape[0]} labels for {y_score.shape[0]} '
                         'scores')
    classes = np.unique(y_true)
    if classes.dtype.kind in 'OUS' or not any(
            np.array_equal(classes, known)
            for known in ([0, 1], [-1, 1], [0], [-1], [1])):
        raise ValueError(f'y_true takes value in {set(classes.tolist())}: '
                         'make y_true take value in {0, 1} or {-1, 1}')
    y_score = y_score.astype(np.float64, copy=False)
    if not (np.isfinite(y_score).all()
            and np.isfinite(y_true.astype(np.float64)).all()):
        raise ValueError('Input contains NaN or infinity')
    order = np.argsort(-y_score, kind='stable')
    y_score = y_score[order]
    positive = (y_true[order] == 1).astype(np.float64)
    # the last index of every run of equal scores, and the end of the curve
    threshold_idxs = np.concatenate(
        [np.nonzero(np.diff(y_score))[0], [positive.size - 1]]).astype(int)
    tps = np.cumsum(positive, dtype=np.float64)[threshold_idxs]
    fps = 1 + threshold_idxs.astype(np.float64) - tps
    return fps, tps, y_score[threshold_idxs]


def roc_curve(y_true, y_score):
    """(fpr, tpr, thresholds) as ``sklearn.metrics.roc_curve`` returns them
    with its defaults: collinear points dropped (``drop_intermediate=True``:
    a point stays where the second difference of fps or tps is not zero),
    a first point (0, 0) at threshold ``inf``, nan rates for a missing
    class."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)
    if fps.shape[0] > 2:
        keep = np.concatenate(
            [[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]])
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds])
    if fps[-1] <= 0:
        warnings.warn('No negative samples in y_true, false positive value '
                      'should be meaningless', RuntimeWarning)
        fpr = np.full(fps.shape, np.nan)
    else:
        fpr = fps / fps[-1]
    if tps[-1] <= 0:
        warnings.warn('No positive samples in y_true, true positive value '
                      'should be meaningless', RuntimeWarning)
        tpr = np.full(tps.shape, np.nan)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thresholds


_trapezoid = getattr(np, 'trapezoid', None) or np.trapz


def auc(x, y) -> float:
    """Area under the points (x, y) by the trapezoid rule; x must be
    monotonic (``sklearn.metrics.auc``)."""
    x = _column(x, 'x')
    y = _column(y, 'y')
    if x.shape[0] != y.shape[0]:
        raise ValueError(f'{x.shape[0]} x values for {y.shape[0]} y values')
    if x.shape[0] < 2:
        raise ValueError('At least 2 points are needed to compute area under '
                         f'curve, but x.shape = {x.shape}')
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError(f'x is neither increasing nor decreasing : {x}.')
    return float(direction * _trapezoid(y, x))


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds), recall decreasing, ending in the
    point (1, 0) (``sklearn.metrics.precision_recall_curve``, defaults)."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)
    precision = tps / (tps + fps)      # tps + fps >= 1 at every threshold
    if tps[-1] == 0:
        warnings.warn('No positive class found in y_true, recall is set to '
                      'one for all thresholds.', RuntimeWarning)
        recall = np.ones_like(tps)
    else:
        recall = tps / tps[-1]
    return (np.concatenate([precision[::-1], [1.0]]),
            np.concatenate([recall[::-1], [0.0]]), thresholds[::-1])


def _binary_pair(y_true, y_pred):
    """Both as 1-d arrays of labels in {0, 1}."""
    y_true = _column(y_true, 'y_true')
    y_pred = _column(y_pred, 'y_pred')
    if y_true.shape[0] != y_pred.shape[0]:
        raise ValueError(f'{y_true.shape[0]} labels for {y_pred.shape[0]} '
                         'predictions')
    present = np.union1d(y_true, y_pred)
    if not np.isin(present, [0, 1]).all():
        raise ValueError(f'labels {present.tolist()} are not binary: expected '
                         'values in {0, 1}')
    return y_true, y_pred


def confusion_matrix(y_true, y_pred, labels=(0, 1)) -> np.ndarray:
    """Counts [i, j] of samples whose true label is ``labels[i]`` and whose
    prediction is ``labels[j]``; other values are left out
    (``sklearn.metrics.confusion_matrix``)."""
    y_true = _column(y_true, 'y_true')
    y_pred = _column(y_pred, 'y_pred')
    if y_true.shape[0] != y_pred.shape[0]:
        raise ValueError(f'{y_true.shape[0]} labels for {y_pred.shape[0]} '
                         'predictions')
    return np.array([[np.sum((y_true == t) & (y_pred == p)) for p in labels]
                     for t in labels], dtype=np.int64)


def accuracy_score(y_true, y_pred) -> float:
    y_true = _column(y_true, 'y_true')
    y_pred = _column(y_pred, 'y_pred')
    if y_true.shape[0] != y_pred.shape[0]:
        raise ValueError(f'{y_true.shape[0]} labels for {y_pred.shape[0]} '
                         'predictions')
    return float(np.mean(y_true == y_pred))


def _ratio(numerator: float, denominator: float, what: str) -> float:
    if denominator == 0:
        warnings.warn(f'{what} is ill-defined and being set to 0.0',
                      RuntimeWarning)
        return 0.0
    return float(numerator / denominator)


def recall_score(y_true, y_pred) -> float:
    """tp / (tp + fn) of the positive label 1; 0.0 without a positive."""
    y_true, y_pred = _binary_pair(y_true, y_pred)
    tp = float(np.sum((y_true == 1) & (y_pred == 1)))
    return _ratio(tp, float(np.sum(y_true == 1)), 'Recall')


def f1_score(y_true, y_pred) -> float:
    """2 tp / (true positives + predicted positives) of the positive label
    1; 0.0 when neither exists."""
    y_true, y_pred = _binary_pair(y_true, y_pred)
    tp = float(np.sum((y_true == 1) & (y_pred == 1)))
    return _ratio(2.0 * tp, float(np.sum(y_true == 1))
                  + float(np.sum(y_pred == 1)), 'F-score')


def roc_auc_score(y_true, y_score) -> float:
    """Area under the ROC curve of a two-class ``y_true``, the larger label
    positive. One class alone raises ValueError, as scikit-learn did up to
    1.6 (later versions warn and return nan; binary_prediction_metrics
    reports nan either way)."""
    y_true = _column(y_true, 'y_true')
    classes = np.unique(y_true)
    if classes.shape[0] != 2:
        raise ValueError('Only one class present in y_true. ROC AUC score is '
                         'not defined in that case.'
                         if classes.shape[0] < 2 else
                         f'y_true has {classes.shape[0]} classes, expected 2')
    fpr, tpr, _ = roc_curve((y_true == classes[1]).astype(int), y_score)
    return auc(fpr, tpr)


# ---- the module's functions, as in the JAX package --------------------------

def _roc_curve(labels: np.ndarray, scores: np.ndarray):
    return roc_curve(labels, scores)


def classification_performance(error_hc, error_patient, training_class: str,
                               optimal_threshold=None, method: str = "roc"
                               ) -> Tuple[float, float, float, float, float]:
    """(roc_auc, accuracy, recall, specificity, significance_ratio).

    Label direction follows group_analysis:115-121: with training_class 'nm'
    patients are the positive class (higher deviation = disease); with 'dm'
    (disease modeling) HC are positive.
    """
    error_hc = np.asarray(error_hc, dtype=float)
    error_patient = np.asarray(error_patient, dtype=float)
    if training_class == "nm":
        labels = np.concatenate(
            [np.zeros_like(error_hc), np.ones_like(error_patient)]
        )
    elif training_class == "dm":
        labels = np.concatenate(
            [np.ones_like(error_hc), np.zeros_like(error_patient)]
        )
    else:
        raise ValueError(f"Unknown training_class: {training_class}")
    predictions = np.concatenate([error_hc, error_patient])

    fpr, tpr, thresholds = _roc_curve(labels, predictions)
    roc_auc = auc(fpr, tpr)

    if optimal_threshold is None:
        if method == "roc":
            optimal_threshold = thresholds[np.argmax(tpr - fpr)]
        elif method == "f1":
            optimal_threshold, _ = find_best_threshold_by_f1(labels, predictions)
        elif method == "pr":
            optimal_threshold = find_best_threshold_by_pr(labels, predictions)
        elif method == "cost":
            optimal_threshold, _ = find_best_threshold_by_cost(
                labels, predictions, cost_fn=1, cost_fp=1
            )
        elif method == "eer":
            optimal_threshold = find_best_threshold_by_eer(labels, predictions)
        else:
            raise ValueError("Unknown method for finding optimal threshold")

    predicted = (predictions >= optimal_threshold).astype(int)
    accuracy = float(np.mean(predicted == labels))
    tp = np.sum((predicted == 1) & (labels == 1))
    fn = np.sum((predicted == 0) & (labels == 1))
    tn = np.sum((predicted == 0) & (labels == 0))
    fp = np.sum((predicted == 1) & (labels == 0))
    recall = tp / (tp + fn)
    specificity = tn / (tn + fp)
    # np.float64 division: AUC == 1.0 yields inf (reference behavior) rather
    # than raising ZeroDivisionError.
    significance_ratio = np.float64(roc_auc) / (1.0 - np.float64(roc_auc))
    return roc_auc, accuracy, float(recall), float(specificity), significance_ratio


def classification_thresholds(error_hc, error_patient):
    """(roc_auc, accuracy, optimal_threshold) with the HC-positive label
    direction (compute_classification_thresholds, group_analysis:39-59)."""
    error_hc = np.asarray(error_hc, dtype=float)
    error_patient = np.asarray(error_patient, dtype=float)
    labels = np.concatenate(
        [np.ones_like(error_hc), np.zeros_like(error_patient)]
    )
    predictions = np.concatenate([error_hc, error_patient])
    fpr, tpr, thresholds = _roc_curve(labels, predictions)
    roc_auc = auc(fpr, tpr)
    optimal_threshold = thresholds[np.argmax(tpr - fpr)]
    predicted = (predictions > optimal_threshold).astype(int)
    accuracy = float(np.mean(predicted == labels))
    return roc_auc, accuracy, optimal_threshold


def _threshold_grid(predictions):
    # the reference scans linspace(0, 1) (group_analysis:63-141), which is
    # only meaningful for probability-like scores; these finders are live
    # here via --threshold_method on raw deviation scores (often all > 1),
    # where a [0,1] scan degenerates to "everything positive". Scan the
    # observed score range instead (same 100-point granularity).
    predictions = np.asarray(predictions, dtype=float)
    return np.linspace(predictions.min(), predictions.max(), 100)


def find_best_threshold_by_f1(labels, predictions):
    best_threshold, best_f1 = 0.0, 0.0
    for threshold in _threshold_grid(predictions):
        predicted = (np.asarray(predictions) >= threshold).astype(int)
        f1 = f1_score(labels, predicted)
        if f1 > best_f1:
            best_f1, best_threshold = f1, threshold
    return best_threshold, best_f1


def find_best_threshold_by_pr(labels, predictions):
    precision, recall, thresholds = precision_recall_curve(labels, predictions)
    with np.errstate(invalid="ignore"):
        f1_scores = 2 * (precision * recall) / (precision + recall)
    # the reference's formula (group_analysis:77-80) leaves 0/0 = NaN where
    # precision = recall = 0; raw argmax would then return the NaN index
    # (e.g. whenever the top-scored sample is a negative) — treat undefined
    # F1 as 0 so the best DEFINED threshold wins
    return thresholds[np.argmax(np.nan_to_num(f1_scores, nan=0.0))]


def find_best_threshold_by_cost(labels, predictions, cost_fn, cost_fp):
    labels = np.asarray(labels)
    best_threshold, best_cost = 0.0, float("inf")
    for threshold in _threshold_grid(predictions):
        predicted = (np.asarray(predictions) >= threshold).astype(int)
        fp = np.sum((predicted == 1) & (labels == 0))
        fn = np.sum((predicted == 0) & (labels == 1))
        cost = fp * cost_fp + fn * cost_fn
        if cost < best_cost:
            best_cost, best_threshold = cost, threshold
    return best_threshold, best_cost


def find_best_threshold_by_eer(labels, predictions):
    fpr, tpr, thresholds = _roc_curve(np.asarray(labels), np.asarray(predictions))
    fnr = 1 - tpr
    return thresholds[np.nanargmin(np.abs(fnr - fpr))]


def binary_prediction_metrics(all_labels, all_preds) -> dict:
    """End-to-end argmax-class metrics (nmpmcont evaluate(), :29-70)."""
    all_labels = np.asarray(all_labels)
    all_preds = np.asarray(all_preds)
    try:
        auroc = roc_auc_score(all_labels, all_preds)
    except ValueError:
        auroc = float("nan")
    # labels pinned so a degenerate single-class fold (the case the
    # roc_auc try/except above already anticipates) still yields a 2x2
    tn, fp, fn, tp = confusion_matrix(all_labels, all_preds,
                                      labels=[0, 1]).ravel()
    return {
        "accuracy": accuracy_score(all_labels, all_preds),
        "auroc": auroc,
        "sensitivity": recall_score(all_labels, all_preds),
        "specificity": (tn / (tn + fp) if (tn + fp) else float("nan")),
        "f1_score": f1_score(all_labels, all_preds),
    }


def _regression_targets(y_true, y_pred):
    """Both arrays 2-D [n, outputs] in their common floating dtype (float64
    when neither is floating), as scikit-learn's regression metrics check
    them (``_check_reg_targets_with_floating_dtype``)."""
    yt, yp = np.asarray(y_true), np.asarray(y_pred)
    floating = [a.dtype for a in (yt, yp)
                if np.issubdtype(a.dtype, np.floating)]
    dtype = np.result_type(*floating) if floating else np.float64
    yt, yp = (a.astype(dtype, copy=False) for a in (yt, yp))
    yt, yp = (a.reshape(-1, 1) if a.ndim == 1 else a for a in (yt, yp))
    if yt.shape != yp.shape:
        raise ValueError(f'y_true {yt.shape} and y_pred {yp.shape} differ')
    return yt, yp


def evaluate_regression(y_true, y_pred) -> dict:
    """RMSE, MAE, R^2 and MAPE of a continuous prediction (JAX
    cli/regression.py:26-33). RMSE, MAE and R^2 are computed as
    scikit-learn's mean_squared_error, mean_absolute_error and r2_score
    compute them (the dtype of the inputs, a mean per output, then the mean
    over outputs; R^2 1 for a perfect prediction, 0 for a constant target);
    MAPE is the reference's own formula."""
    yt, yp = _regression_targets(y_true, y_pred)
    mse = float(np.average(np.average((yt - yp) ** 2, axis=0)))
    mae = float(np.average(np.average(np.abs(yp - yt), axis=0)))
    if yt.shape[0] < 2:
        warnings.warn('R^2 score is not well-defined with less than two '
                      'samples.')
        r2 = float('nan')
    else:
        num = np.sum((yt - yp) ** 2, axis=0)
        den = np.sum((yt - np.average(yt, axis=0)) ** 2, axis=0)
        scores = np.ones(yt.shape[1], dtype=num.dtype)
        valid = (num != 0) & (den != 0)
        scores[valid] = 1 - (num[valid] / den[valid])
        scores[(num != 0) & (den == 0)] = 0.0
        r2 = float(np.average(scores))
    mape = np.mean(np.abs((y_true - y_pred) / (y_true + 1e-6))) * 100
    return {'RMSE': np.sqrt(mse), 'MAE': mae, 'R2': r2, 'MAPE': mape}
