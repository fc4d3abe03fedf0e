"""Runtime helpers: ``-debug`` tracing, stage timing.

The port of ``mercat2_tpu.utils.runtime``. ``DebugTrace`` records a
``torch.profiler`` trace of the run where the JAX package records a
``jax.profiler`` one; ``enable_compilation_cache`` has no counterpart,
since PyTorch runs eagerly and the CUDA kernels are built once into a
library (``ops/_build.py``).
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

__all__ = ["DebugTrace", "StageTimer", "mem_use"]


def mem_use() -> str:
    """Current host RAM usage, GB (MerCat2's mem_use,
    bin/mercat2.py:31-32)."""
    try:
        import psutil

        return f"{psutil.virtual_memory().used / 1024**3:.2f} GB"
    except ImportError:  # pragma: no cover
        return "n/a"


class DebugTrace:
    """Optional observability for ``-debug`` runs: prints host RAM at each
    stage (MerCat2 gates the same prints on its hidden ``-debug`` flag)
    and records a ``torch.profiler`` trace of the whole run, CPU activity
    and, on a CUDA device, the card's, exported as a Chrome trace
    (``trace.json`` in ``trace_dir``; open it in Perfetto or
    chrome://tracing)."""

    def __init__(self, enabled: bool, trace_dir=None, device=None):
        self.enabled = enabled
        self.trace_dir = Path(trace_dir) if trace_dir else None
        self.device = torch.device(device) if device is not None else None
        self._prof = None

    def __enter__(self):
        if self.enabled and self.trace_dir:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device is not None and self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
            print(f"[debug] torch profiler trace -> {self.trace_dir}")
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            self.trace_dir.mkdir(parents=True, exist_ok=True)
            self._prof.export_chrome_trace(str(self.trace_dir / "trace.json"))
            self._prof = None
        return False

    def stage(self, name: str) -> None:
        if self.enabled:
            print(f"[debug] {name}: host RAM {mem_use()}")


class StageTimer:
    """Named wall-clock stage timer with a report() summary."""

    def __init__(self, verbose: bool = True):
        self.verbose = verbose
        self.stages: list[tuple[str, float]] = []
        self._t0: float | None = None
        self._name: str | None = None

    def start(self, name: str) -> None:
        self.stop()
        self._name = name
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is not None:
            dt = time.perf_counter() - self._t0
            self.stages.append((self._name, dt))
            if self.verbose:
                print(f"Time to {self._name}: {round(dt, 2)} seconds")
            self._t0 = None
            self._name = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
