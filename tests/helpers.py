"""Small codes and inputs shared by the decoder tests."""

import numpy as np

from ldpcgputegra.codes.code import DegreeClass, Layer, LdpcCode, QCRow
from ldpcgputegra.codes.dvbs2 import _conflict_groups, to_qc_form


def llrs(n, b, seed=0, sigma=0.8):
    """Channel-like int8 LLRs of the all-zero codeword (bit 0 <-> < 0)."""
    rng = np.random.default_rng(seed)
    return np.clip(
        8.0 * rng.normal(-1.0, sigma, size=(b, n)), -31, 31
    ).astype(np.int8)


def dup_col_code(z=8):
    """Two block-rows with repeated block-columns (sub-pass split), sharing
    a column — the structure of the DVB-S2 rate-2/3 views."""
    rows = [
        (np.array([0, 1, 1], np.int32), np.array([0, 1, 4], np.int32)),
        (np.array([1, 2, 2], np.int32), np.array([2, 0, 3], np.int32)),
    ]
    zz = np.arange(z, dtype=np.int64)[:, None]
    layers, classes, class_idx = [], [], []
    off = 0
    for cols, shifts in rows:
        idx = (cols[None, :] * z + (shifts[None, :] + zz) % z).astype(np.int32)
        for g in _conflict_groups(cols, shifts, z):
            layers.append(Layer(idx=idx, edge_offset=off,
                                qc=QCRow(cols=cols, shifts=shifts,
                                         commit_rows=g)))
        classes.append(DegreeClass(3, z))
        class_idx.append(idx)
        off += idx.size
    return LdpcCode(name="dup2", N=3 * z, K=z, classes=tuple(classes),
                    class_idx=tuple(class_idx), Z=z, layers=tuple(layers))


def tiny_staircase_view(z=8, q=3, groups=3, deg=3, seed=1):
    """QC view (``to_qc_form``) of a small DVB-S2-style staircase code:
    info group g scatters to checks ``(a + t*q) mod M`` for its addresses
    a, then the staircase parity pair.  The view has a deficient circulant
    (the absent p_{-1} at check 0) and, for this seed, sub-pass layers."""
    K, M = groups * z, q * z
    rng = np.random.default_rng(seed)
    rows = [[] for _ in range(M)]
    for g in range(groups):
        for a in rng.choice(M, size=deg, replace=False):
            for t in range(z):
                rows[(a + t * q) % M].append(g * z + t)
    for r in range(M):
        rows[r] += [K + r] + ([K + r - 1] if r else [])
    classes, class_idx, r = [], [], 0
    while r < M:
        e = r
        while e < M and len(rows[e]) == len(rows[r]):
            e += 1
        classes.append(DegreeClass(len(rows[r]), e - r))
        class_idx.append(np.asarray(rows[r:e], np.int32))
        r = e
    code = LdpcCode(name=f"stair-z{z}-s{seed}", N=K + M, K=K,
                    classes=tuple(classes), class_idx=tuple(class_idx))
    return to_qc_form(code, z=z)
