"""Golden (reference-semantics) fixed-point decoder oracles.

``decode_golden`` — readable NumPy specification (slow, scalar).
``decode_oracle`` — batched dispatcher: native C++ oracle when built,
NumPy fallback otherwise.  Both are bit-identical by test contract.
``decode_scheduled`` — the oracle run in the check order the jitted
decoders use for a code and schedule (``schedule_view``).
``params_for`` — the oracle parameters equivalent to a ``LayeredSpec``.
"""

from __future__ import annotations

import numpy as np

from .decoder import GoldenParams, decode_golden, syndrome_ok  # noqa: F401


def decode_oracle(code, llr_batch, params: GoldenParams = GoldenParams()):
    """Batched golden decode [B, N] -> (bits [B, N] int8, iters_used [B])."""
    from .native import decode_golden_native, native_available

    llr_batch = np.asarray(llr_batch)
    if llr_batch.ndim == 1:
        llr_batch = llr_batch[None, :]
    if native_available():
        return decode_golden_native(code, llr_batch, params)
    bits = np.empty_like(llr_batch)
    used = np.empty(llr_batch.shape[0], np.int32)
    for b in range(llr_batch.shape[0]):
        bits[b], used[b] = decode_golden(code, llr_batch[b], params)
    return bits, used


def params_for(spec) -> GoldenParams:
    """``GoldenParams`` equivalent to an ``ops.layered.LayeredSpec``."""
    return GoldenParams(
        algo=spec.algo, iters=spec.iters, offset=spec.offset,
        early_term=spec.early_term, minclamp=spec.minclamp,
        sat_var=spec.sat_var, sat_msg=spec.sat_msg,
        nms_factor=spec.nms_f / 32.0, nms_factor2=spec.nms_f2 / 32.0,
    )


def schedule_view(code, schedule: str = "auto"):
    """``(view, col_perm)``: a code whose reference check order IS the
    layered schedule the jitted decoders run for ``code`` — the QC view of
    a staircase code, a colored schedule, sub-pass commits (only committed
    rows), deficient circulants (the masked edge truly absent).  Checks of
    one layer touch disjoint VNs, so their order inside a layer is free.
    ``col_perm`` is the view's column permutation (None if none)."""
    from ..codes.code import DegreeClass, LdpcCode
    from ..codes.schedule import build_layers
    from ..decoder import effective_code

    eff = effective_code(code)
    classes, class_idx = [], []

    def add(idx):
        if idx.shape[0]:
            classes.append(DegreeClass(idx.shape[1], idx.shape[0]))
            class_idx.append(np.ascontiguousarray(idx, np.int32))

    for lay in build_layers(eff, schedule):
        q = lay.qc
        rows = np.arange(lay.n_checks)
        if q is not None and q.commit_rows is not None:
            rows = np.asarray(q.commit_rows)
        if q is None or q.mask_edge is None:
            add(lay.idx[rows])
            continue
        masked = np.isin(rows, q.mask_rows)
        add(lay.idx[rows[~masked]])
        add(np.delete(lay.idx[rows[masked]], q.mask_edge, axis=1))
    view = LdpcCode(name=eff.name + "-schedule", N=eff.N, K=eff.K,
                    classes=tuple(classes), class_idx=tuple(class_idx))
    return view, eff.col_perm


def decode_scheduled(code, llr_batch, params: GoldenParams = GoldenParams(),
                     schedule: str = "auto"):
    """Golden decode in the jitted decoders' schedule order; bits come
    back in ``code``'s own column order.  ``(bits [B, N], iters [B])``."""
    view, perm = schedule_view(code, schedule)
    llr_batch = np.atleast_2d(np.asarray(llr_batch))
    if perm is None:
        return decode_oracle(view, llr_batch, params)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    bits, used = decode_oracle(view, llr_batch[:, perm], params)
    return bits[:, inv], used
