"""The stdout metric-block contract.

In the reference, stdout *is* the API between the train/eval engine and the
automation layer: ``train_eval.py:47-51,94-118`` prints a standard block and
``runner.py:108-135`` regex-scrapes seven metrics from it (raising if any
pattern is missing). We keep that exact contract — the same lines, the same
formats — so existing scrape tooling keeps working, and additionally expose
the metrics as structured values (our in-process sweep runner consumes those
directly instead of scraping).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["RunMetrics", "print_metric_block", "extract_metrics"]


@dataclass
class RunMetrics:
    accuracy: float = 0.0
    precision: float = 0.0
    recall: float = 0.0
    f1: float = 0.0
    training_duration: float = 0.0
    inference_duration: float = 0.0
    trainable_params: int = 0
    non_trainable_params: int = 0
    total_params: int = 0
    per_class: Dict[str, Dict[str, float]] = field(default_factory=dict)
    epoch_losses: List[float] = field(default_factory=list)
    epoch_accs: List[float] = field(default_factory=list)
    val_losses: List[float] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "accuracy": self.accuracy,
            "precision": self.precision,
            "recall": self.recall,
            "f1_score": self.f1,
            "training_duration": self.training_duration,
            "inference_duration": self.inference_duration,
            "trainable_param": self.trainable_params,
        }


def print_epoch_line(epoch: int, num_epochs: int, loss: float, acc: float) -> None:
    # train_eval.py:47-48
    print(f"Epoch {epoch + 1}/{num_epochs}, Loss: {loss:.4f}, Accuracy: {acc:.4f}")


def print_training_duration(seconds: float) -> None:
    # train_eval.py:51
    print(f"training_duration: {seconds:.4f}")


def print_inference_duration(seconds: float) -> None:
    # train_eval.py:118
    print(f"inference_duration: {seconds:.4f}")


def print_param_counts(trainable: int, non_trainable: int) -> None:
    # main.py:153 prints the dict returned by count_parameters (train_eval.py:121-129);
    # runner.py:116 scrapes the "'Trainable parameters': N" repr form.
    print(
        {
            "Trainable parameters": trainable,
            "Non-trainable parameters": non_trainable,
            "Total parameters": trainable + non_trainable,
        }
    )


def print_metric_block(
    metrics: RunMetrics,
    class_names: List[str],
    classif_mode: str = "multiclass",
) -> None:
    """Print the eval metric block exactly as ``train_eval.py:80-118`` does."""
    if classif_mode == "multiple_binary":
        for name in class_names:
            pc = metrics.per_class.get(name, {})
            print(
                f"Class {name} - Precision: {pc.get('precision', 0.0):.4f}, "
                f"Recall: {pc.get('recall', 0.0):.4f}, "
                f"f1-Score: {pc.get('f1', 0.0):.4f}, "
                f"Accuracy: {pc.get('accuracy', 0.0):.4f}"
            )
        print(
            f"Overall Precision: {metrics.precision:.4f}, "
            f"Overall Recall: {metrics.recall:.4f}, "
            f"Overall F1-Score: {metrics.f1:.4f}"
        )
        print(f"Overall Accuracy: {metrics.accuracy:.4f}")
    else:
        print(f"Overall Accuracy: {metrics.accuracy:.4f}")
        for name in class_names:
            pc = metrics.per_class.get(name, {})
            print(
                f"Class: {name} - Precision: {pc.get('precision', 0.0):.4f}, "
                f"Recall: {pc.get('recall', 0.0):.4f}, "
                f"f1-Score: {pc.get('f1', 0.0):.4f}"
            )
        print(
            f"Overall Precision: {metrics.precision:.4f}, "
            f"Overall Recall: {metrics.recall:.4f}, "
            f"Overall F1-Score: {metrics.f1:.4f}"
        )
    print_inference_duration(metrics.inference_duration)


# The exact scrape patterns of runner.py:109-117.
_PATTERNS = {
    "accuracy": r"Overall Accuracy: (\d\.\d+|\d\.\d)",
    "precision": r"Overall Precision: (\d\.\d+|\d\.\d)",
    "recall": r"Overall Recall: (\d\.\d+|\d\.\d)",
    "f1": r"Overall F1-Score: (\d\.\d+|\d\.\d)",
    "train_duration": r"training_duration:\s+([\d.]+)",
    "inf_duration": r"inference_duration:\s+([\d.]+)",
    "trainable_params": r"'Trainable parameters':\s+(\d+)",
}


def extract_metrics(output: str) -> RunMetrics:
    """Parse a captured stdout block back into RunMetrics.

    Raises ValueError on a missing metric, matching ``runner.py:119-125``.
    """
    vals = {}
    for key, pattern in _PATTERNS.items():
        m = re.search(pattern, output)
        if m is None:
            raise ValueError(f"Could not find a match for {key} in the output.")
        vals[key] = int(m.group(1)) if key == "trainable_params" else float(m.group(1))
    return RunMetrics(
        accuracy=vals["accuracy"],
        precision=vals["precision"],
        recall=vals["recall"],
        f1=vals["f1"],
        training_duration=vals["train_duration"],
        inference_duration=vals["inf_duration"],
        trainable_params=vals["trainable_params"],
    )


def parse_optional(output: str) -> Optional[RunMetrics]:
    try:
        return extract_metrics(output)
    except ValueError:
        return None
