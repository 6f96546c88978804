#!/usr/bin/env python3
"""Generate fixed-seed golden decode vectors (tests/vectors/*.npz).

Each vector file: llr [B, N] int8 inputs + expected bits [B, N] for one
(code, algo, iters, minclamp) configuration, produced by the NumPy golden
specification.  The vectors pin the decoder semantics independently of any
oracle implementation — a regression net for all future rounds.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ldpcgputegra.codes.registry import load_code  # noqa: E402
from ldpcgputegra.golden import GoldenParams, decode_oracle  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "vectors")

CASES = [
    ("576x288", "MS", 5, "post", 0),
    ("576x288", "OMS", 10, "pre", 1),
    ("576x288", "NMS", 5, "post", 0),
    ("576x288", "2NMS", 5, "post", 0),
    ("1944x972", "OMS", 10, "pre", 1),
    ("2304x1152", "OMS", 5, "pre", 1),
]


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    for name, algo, iters, minclamp, offset in CASES:
        code = load_code(name)
        rng = np.random.default_rng(20260816)
        llr = np.clip(
            8.0 * rng.normal(-1.0, 0.8, size=(8, code.N)), -31, 31
        ).astype(np.int8)
        gp = GoldenParams(
            algo=algo, iters=iters, minclamp=minclamp, offset=offset
        )
        bits, used = decode_oracle(code, llr, gp)
        fn = os.path.join(OUT, f"{name}_{algo}_{iters}_{minclamp}.npz")
        np.savez_compressed(
            fn,
            llr=llr,
            bits=bits,
            iters_used=used,
            algo=algo,
            iters=iters,
            minclamp=minclamp,
            offset=offset,
            code=name,
        )
        print(f"wrote {os.path.basename(fn)} ({bits.sum()} error bits)")


if __name__ == "__main__":
    main()
