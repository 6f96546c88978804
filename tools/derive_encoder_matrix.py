#!/usr/bin/env python3
"""Derive the parity-check matrix implied by a DVB accumulate-encoder table
(codes/data/encoder_*.json) and register it as a loadable code.

The reference ships the N=16200, K=10800 encoder table
(GenericEncoderTable.h) but no matching H matrix — it could encode frames
it could never decode.  The accumulator defines H exactly: check r
contains every info VN x whose table line scatters to r, plus the
staircase pair (p_{r-1}, p_r).  The derived code is validated against the
encoder (every encoded frame satisfies every check) before saving.

Usage: python tools/derive_encoder_matrix.py [encoder_16200x10800.json]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ldpcgputegra.channel.encoder import QCAccumulateEncoder  # noqa: E402
from ldpcgputegra.codes.code import LdpcCode  # noqa: E402
from ldpcgputegra.golden.decoder import syndrome_ok  # noqa: E402

DATA = os.path.join(
    os.path.dirname(__file__), "..", "ldpcgputegra", "codes", "data"
)


def derive(table_path: str) -> str:
    doc = json.load(open(table_path))
    N, K, Q, M360 = doc["N"], doc["K"], doc["Q"], doc["M"]
    nmk = N - K
    rows_info: list[list[int]] = [[] for _ in range(nmk)]
    for g, line in enumerate(doc["rows"]):
        p = np.asarray(line, dtype=np.int64)
        for t in range(M360):
            x = g * M360 + t
            for r in (p + (t % M360) * Q) % nmk:
                rows_info[int(r)].append(x)
    checks = []
    for r in range(nmk):
        vns = (
            sorted(set(rows_info[r]))
            + ([K + r - 1] if r > 0 else [])
            + [K + r]
        )
        checks.append(np.asarray(sorted(vns), dtype=np.int32))
    from collections import defaultdict

    by_deg = defaultdict(list)
    for c in checks:
        by_deg[len(c)].append(c)
    classes, edges = [], []
    for deg in sorted(by_deg, reverse=True):
        blk = np.stack(by_deg[deg])
        classes.append((deg, blk.shape[0]))
        edges.append(blk.ravel())
    code = LdpcCode.from_edges(
        f"{N}x{K}", N, None, classes, np.concatenate(edges), detect_qc=False
    )
    assert code.K == K, "encoder table K inconsistent with check count"
    enc = QCAccumulateEncoder(N, K, Q, M360, doc["rows"])
    rng = np.random.default_rng(1)
    info = rng.integers(0, 2, size=(4, K)).astype(np.int8)
    coded = enc.encode(info)
    assert all(syndrome_ok(code, coded[b]) for b in range(4)), (
        "derived H inconsistent with encoder"
    )
    out = os.path.join(DATA, f"{N}x{K}.npz")
    np.savez_compressed(
        out,
        N=N,
        # stored K follows the registry's check-count convention
        K=np.int64(code.n_checks),
        Z=0,
        classes=np.asarray([(c.deg, c.count) for c in code.classes]),
        edges=code.edges,
    )
    print(f"ok {N}x{K}: M={code.M} checks={code.n_checks} -> {out}")
    return out


if __name__ == "__main__":
    path = (
        sys.argv[1]
        if len(sys.argv) > 1
        else os.path.join(DATA, "encoder_16200x10800.json")
    )
    derive(path)
