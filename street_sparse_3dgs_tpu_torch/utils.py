"""Shared runtime utilities, mirroring ``street_sparse_3dgs_tpu/utils.py``:
deterministic host state, timestamped logging, per-stage wall-clock timing
with optional profiler traces, and the loss meter.

  - ``safe_state``: host RNG seeding (Python, numpy and torch's default
    generator) and timestamped stdout (the reference's
    ``utils/general_utils.py``); the device draws of the port come from
    explicit ``torch.Generator`` objects;
  - ``stage_timer``: per-stage durations appended to
    ``training_pipeline_timing.txt`` (``complete_training.sh:16-60``), the
    card synchronised before the end time is read, and a ``torch.profiler``
    trace on request.
"""

from __future__ import annotations

import contextlib
import random
import sys
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch


class _TimestampedStream:
    def __init__(self, wrapped):
        self._wrapped = wrapped
        self._at_line_start = True

    def write(self, text):
        for chunk in text.splitlines(keepends=True):
            if self._at_line_start and chunk.strip():
                stamp = datetime.now().strftime("%d/%m %H:%M:%S")
                self._wrapped.write(f"[{stamp}] ")
            self._wrapped.write(chunk)
            self._at_line_start = chunk.endswith("\n")

    def flush(self):
        self._wrapped.flush()

    def __getattr__(self, name):
        return getattr(self._wrapped, name)


def safe_state(silent: bool = False, seed: int = 0) -> None:
    """Seed the host RNGs and timestamp every stdout line (the reference's
    ``safe_state``).  The wrapper stays on ``sys.stdout`` until the caller
    puts the old stream back."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if not silent and not isinstance(sys.stdout, _TimestampedStream):
        sys.stdout = _TimestampedStream(sys.stdout)


def _sync_card() -> None:
    """Wait for queued device work, where CUDA is in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def stage_timer(name: str, log_path: str | Path | None = None,
                profile_dir: str | Path | None = None):
    """Time a pipeline stage; append ``<name>: <seconds>`` to the timing log
    (the run_and_log format) and optionally write a ``torch.profiler``
    Chrome trace to ``profile_dir/<name>/trace.json``.  The card is
    synchronised before the end time is read, so that a stage's time
    includes its queued device work."""
    prof = None
    if profile_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    t0 = time.time()
    with prof if prof is not None else contextlib.nullcontext():
        yield
        _sync_card()
    dt = time.time() - t0
    if prof is not None:
        out = Path(profile_dir) / name
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
    line = f"{name}: {dt:.2f} s"
    print(line)
    if log_path is not None:
        path = Path(log_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as f:
            f.write(line + "\n")


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
