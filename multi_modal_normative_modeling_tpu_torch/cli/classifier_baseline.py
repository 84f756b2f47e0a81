"""MLP diagnosis classifier baseline (counterpart of
cli/classifier_baseline.py).

Drop-in CLI for classifier_baseline/classifier.py: loads an fMRI feature CSV
and a labels CSV joined on IID, does the reference's stratified split
(classifier.py:169-215, nominally "70/10/20" but val_size=0.1 applies to
the 80% remainder, so effectively 72/8/20; reproduced exactly by the port's
numpy copy of scikit-learn's split, data/splits.py), trains the MLP
full-batch with Adam + ReduceLROnPlateau + best-val checkpointing
(models/classifier.py, the epoch loop on the device with no host sync), and
writes the checkpoint (``<stem>.ckpt`` + ``.json`` beside
``--checkpoint_path``, the JAX package's format), <checkpoint>_metrics.txt,
the appended experiment_results.json and logs/experiment.log.

``--device`` chooses the device: the card by default, ``cpu`` for the CPU
(the JAX CLI accepts the flag and ignores it).

    python -m multi_modal_normative_modeling_tpu_torch.cli.classifier_baseline \
        --fmri_path data/ADHD/fMRI.csv --labels_path data/ADHD/y.csv \
        [--hidden_layers 116 64 32] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from ..data.splits import train_test_split
from ..interop import classifier_to_jax
from ..models.classifier import (
    MLPClassifier,
    evaluate_classifier,
    train_classifier,
)
from ..train.checkpoints import save_checkpoint
from . import common


def setup_logging(log_level: str = "INFO", log_dir: str = "logs") -> None:
    os.makedirs(log_dir, exist_ok=True)
    logging.basicConfig(
        level=getattr(logging, log_level.upper()),
        format="%(asctime)s - %(levelname)s - %(message)s",
        handlers=[
            logging.StreamHandler(),
            logging.FileHandler(os.path.join(log_dir, "experiment.log")),
        ],
        force=True,
    )


def load_data(fmri_path: str, labels_path: str):
    """Join features and labels on IID (classifier.py:133-166)."""
    fmri_data = pd.read_csv(fmri_path)
    labels_data = pd.read_csv(labels_path)
    if "IID" not in fmri_data.columns or "IID" not in labels_data.columns:
        raise ValueError("Both fMRI and labels data must contain an 'IID' column.")
    fmri_data.set_index("IID", inplace=True)
    labels_data.set_index("IID", inplace=True)
    filtered = fmri_data.loc[labels_data.index]
    if "DIA" not in labels_data.columns:
        raise ValueError("Labels data must contain a 'DIA' column.")
    return filtered.values, labels_data["DIA"].values


def prepare_splits(X, y, test_size=0.2, val_size=0.1, random_state=42):
    X_train_full, X_test, y_train_full, y_test = train_test_split(
        X, y, test_size=test_size, random_state=random_state, stratify=y)
    X_train, X_val, y_train, y_val = train_test_split(
        X_train_full, y_train_full, test_size=val_size,
        random_state=random_state, stratify=y_train_full)
    to32 = lambda a: np.asarray(a, dtype=np.float32)
    toi = lambda a: np.asarray(a, dtype=np.int32)
    return (to32(X_train), to32(X_val), to32(X_test),
            toi(y_train), toi(y_val), toi(y_test))


def record_experiment(args, metrics, filename="./experiment_results.json"):
    with open(filename, "a") as f:
        json.dump({"arguments": vars(args), "metrics": metrics}, f, indent=4)
        f.write("\n")


def init_model(input_size: int, hidden_layers, dropout: float, device,
               seed: int = 42) -> MLPClassifier:
    """The port's own init: torch nn.Linear's default draws from a
    generator seeded ``seed`` (tests carry the JAX init across instead)."""
    return MLPClassifier(input_size, hidden_layers, dropout,
                         generator=torch.Generator().manual_seed(seed),
                         device=device)


def main(args, init_fn=None):
    """``init_fn(input_size, hidden_layers, dropout, device)`` replaces the
    initialisation (tests load the JAX package's init through it)."""
    device = common.resolve_device(args.device, 'train the classifier')
    setup_logging(args.log_level)
    logging.info("Experiment Configuration:")
    for arg, value in vars(args).items():
        logging.info(f"{arg}: {value}")
    np.random.seed(42)

    X, y = load_data(args.fmri_path, args.labels_path)
    X_train, X_val, X_test, y_train, y_val, y_test = prepare_splits(X, y)
    logging.info(f"Training set size: {X_train.shape[0]}")
    logging.info(f"Validation set size: {X_val.shape[0]}")
    logging.info(f"Testing set size: {X_test.shape[0]}")

    model = (init_fn or init_model)(X_train.shape[1], args.hidden_layers,
                                    args.dropout, device)

    logging.info("Starting training")
    best, history = train_classifier(
        model, X_train, y_train, X_val, y_val,
        num_epochs=args.num_epochs, initial_lr=args.initial_lr,
        factor=args.factor, patience=args.patience, min_lr=args.min_lr,
    )
    logging.info("Training completed")

    ckpt_dir = Path(args.checkpoint_path).parent  # '.' for bare filenames
    ckpt_name = Path(args.checkpoint_path).stem
    save_checkpoint(ckpt_dir, classifier_to_jax(best, 0),
                    {"hidden_layers": list(args.hidden_layers),
                     "dropout": args.dropout,
                     "input_size": int(X_train.shape[1])},
                    name=ckpt_name)

    metrics = evaluate_classifier(best, X_test, y_test)
    logging.info("Evaluation Metrics:")
    for metric, value in metrics.items():
        logging.info(f"{metric}: {value:.4f}")

    record_experiment(args, metrics)
    metrics_path = os.path.splitext(args.checkpoint_path)[0] + "_metrics.txt"
    with open(metrics_path, "w") as f:
        for metric, value in metrics.items():
            f.write(f"{metric}: {value:.4f}\n")
    logging.info(f"Saved evaluation metrics to {metrics_path}")
    return metrics


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train an MLP model for diagnosis classification.")
    parser.add_argument("--fmri_path", type=str,
                        default="data/ADHD/fMRI.csv",
                        help="Path to the fMRI data CSV file.")
    parser.add_argument("--labels_path", type=str,
                        default="data/ADHD/y.csv",
                        help="Path to the labels CSV file.")
    parser.add_argument("--num_epochs", type=int, default=1000,
                        help="Number of training epochs.")
    parser.add_argument("--initial_lr", type=float, default=0.0001,
                        help="Initial learning rate for the optimizer.")
    parser.add_argument("--patience", type=int, default=10,
                        help="Epochs with no improvement before LR reduction.")
    parser.add_argument("--factor", type=float, default=0.5,
                        help="Factor by which the learning rate is reduced.")
    parser.add_argument("--min_lr", type=float, default=1e-9,
                        help="Minimum learning rate.")
    parser.add_argument("--hidden_layers", type=int, nargs="+",
                        default=[116, 64, 32], help="Hidden layer sizes.")
    parser.add_argument("--dropout", type=float, default=0.0,
                        help="Dropout rate between layers.")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="Unused (full batch), kept for flag parity.")
    parser.add_argument("--checkpoint_path", type=str,
                        default="best_model.pth",
                        help="Path to save the best model checkpoint.")
    parser.add_argument("--log_level", type=str, default="INFO",
                        choices=["DEBUG", "INFO", "WARNING", "ERROR",
                                 "CRITICAL"], help="Logging level.")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cpu", "cuda"],
                        help="Device to train on (default: the card).")
    return parser


def run(argv=None, init_fn=None):
    args = build_parser().parse_args(argv)
    return main(args, init_fn=init_fn)


if __name__ == "__main__":
    run()
