"""Device timing: warm-up, then ``block_until_ready`` windows.

JAX returns before the device finishes, so a timing that does not end in
``block_until_ready`` measures the enqueue.  ``measure_call`` warms every
input once (compilation stays out of the window), then times windows of
calls that each end in ``block_until_ready`` and reports the median
window's time per call.  This replaces the reference's CUDA-event timing
(``code/gpu_fixed/timer/CTimer.cu:31-60``), whose role was the same.
"""

from __future__ import annotations

import time
from typing import Callable, Mapping, Sequence

import jax
import numpy as np

__all__ = ["measure_call", "throughput_report"]


def measure_call(fn: Callable | Mapping[str, Callable],
                 inputs: Sequence | Mapping[str, Sequence],
                 windows: int = 5):
    """Seconds per ``fn(x)`` call: each window calls ``fn`` once on every
    input in turn and ends in ``block_until_ready``; median window.

    ``fn`` may be a dict of functions: they are timed in alternating
    windows (one window of each in turn, so a drift of the card's clock
    touches all of them alike) and a dict of seconds per call comes back.
    ``inputs`` is then one list for all of them or a dict of lists keyed
    like ``fn``."""
    fns = fn if isinstance(fn, Mapping) else {None: fn}
    xs = {k: inputs[k] if isinstance(inputs, Mapping) else inputs
          for k in fns}
    for k, f in fns.items():
        for x in xs[k]:
            jax.block_until_ready(f(x))
    per_call = {k: [] for k in fns}
    for _ in range(windows):
        for k, f in fns.items():
            t0 = time.perf_counter()
            out = None
            for x in xs[k]:
                out = f(x)
            jax.block_until_ready(out)
            per_call[k].append((time.perf_counter() - t0) / len(xs[k]))
    med = {k: float(np.median(v)) for k, v in per_call.items()}
    return med if isinstance(fn, Mapping) else med[None]


def throughput_report(
    seconds_per_call: float, frames: int, n: int
) -> dict:
    """Coded-throughput numbers in the reference's accounting
    (coded bits / wall time, ``code/gpu_fixed/main.cpp:311-315``)."""
    coded_bits = frames * n
    return {
        "ms_per_call": seconds_per_call * 1e3,
        "frames_per_s": frames / seconds_per_call,
        "coded_mbps": coded_bits / seconds_per_call / 1e6,
        "coded_gbps": coded_bits / seconds_per_call / 1e9,
    }
