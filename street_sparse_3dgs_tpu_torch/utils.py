"""Shared runtime utilities, mirroring ``street_sparse_3dgs_tpu/utils.py``
(the loss meter; the stage timer and logging belong to the pipeline
slice)."""

from __future__ import annotations


class EmaMeter:
    """Progress-bar loss smoothing (reference: 0.4·new + 0.6·old,
    ``train_single.py:166-178``)."""

    def __init__(self, alpha: float = 0.4):
        self.alpha = alpha
        self.value: float | None = None

    def update(self, x: float) -> float:
        self.value = x if self.value is None else (
            self.alpha * x + (1 - self.alpha) * self.value)
        return self.value
