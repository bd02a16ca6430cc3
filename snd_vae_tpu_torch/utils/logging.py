"""Metrics logging — the port of ``snd_vae_tpu/utils/logging.py``.

``LossesLogger(path).log(epoch, storer)``, where ``storer`` maps a loss name
to its per-batch values, appends the per-epoch means to a text log
(``epoch,loss,value`` rows, as ``train_loss_{dataset}_{model_type}.txt``)
and one JSON object per epoch to the ``.jsonl`` beside it: the same files,
in the same formats, as the JAX package writes.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Mapping, Sequence, Union

Number = Union[int, float]


def epoch_means(storer: Mapping[str, Sequence[Number]]) -> Dict[str, float]:
    """The mean of each loss's per-batch values."""
    return {k: float(sum(v)) / max(len(v), 1) for k, v in storer.items()}


class LossesLogger:
    def __init__(self, path: str):
        self.path = path
        self.jsonl_path = os.path.splitext(path)[0] + ".jsonl"
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # a fresh pair of files per run
        with open(self.path, "w") as f:
            f.write("epoch,loss,value\n")
        with open(self.jsonl_path, "w"):
            pass

    def log(self, epoch: int, storer: Mapping[str, Sequence[Number]]) -> Dict[str, float]:
        """Append the per-epoch mean of each loss list; returns the means."""
        means = epoch_means(storer)
        with open(self.path, "a") as f:
            for k, v in means.items():
                f.write(f"{epoch},{k},{v}\n")
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({"epoch": epoch, "time": time.time(), **means}) + "\n")
        return means
