"""Profiler integration (SURVEY aux #1 — the reference has manual timers
only; the device equivalent is a jax.profiler trace you can open in
TensorBoard/Perfetto/XProf)."""

from __future__ import annotations

import contextlib
import os
import time

__all__ = ["trace", "timed"]


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a device trace around a code block.

    View with: ``tensorboard --logdir <dir>`` (Profile tab) or upload the
    .trace.json.gz to Perfetto.
    """
    import jax

    log_dir = log_dir or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        ".traces", time.strftime("%Y%m%d-%H%M%S"),
    )
    os.makedirs(log_dir, exist_ok=True)
    with jax.profiler.trace(log_dir):
        yield log_dir


@contextlib.contextmanager
def timed(label: str):
    """Host-side wall timing with the reference's (PERF) line convention."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    print(f"(PERF) {label}: {dt * 1e3:.3f} ms")
