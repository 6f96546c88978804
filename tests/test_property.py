"""Property-based fuzzing: random codes x random LLRs x random configs,
XLA decoder vs the native C++ oracle must agree bit for bit."""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from ldpcgputegra.codes.registry import make_qc_code, make_random_regular_code
from ldpcgputegra.golden import GoldenParams, decode_oracle
from ldpcgputegra.golden.native import native_available
from ldpcgputegra.ops.layered import LayeredSpec, make_layered_decoder

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native oracle not built"
)

_algos = st.sampled_from(["MS", "OMS", "NMS", "2NMS"])
_clamp = st.sampled_from(["pre", "post"])


@settings(max_examples=15, deadline=None)
@given(
    seed=st.integers(0, 10_000),
    algo=_algos,
    minclamp=_clamp,
    iters=st.integers(1, 6),
    offset=st.integers(0, 2),
)
def test_random_regular_code_agrees(seed, algo, minclamp, iters, offset):
    code = make_random_regular_code(128, 64, 4, seed=seed % 7)
    rng = np.random.default_rng(seed)
    llr = np.clip(
        8.0 * rng.normal(-1.0, 0.9, size=(2, code.N)), -31, 31
    ).astype(np.int8)
    spec = LayeredSpec(
        algo=algo, iters=iters, minclamp=minclamp, offset=offset,
        schedule="reference",
    )
    bits = np.asarray(make_layered_decoder(code, spec)(llr)[0])
    gp = GoldenParams(
        algo=algo, iters=iters, minclamp=minclamp, offset=offset
    )
    refs, _ = decode_oracle(code, llr, gp)
    np.testing.assert_array_equal(bits, refs)


@settings(max_examples=10, deadline=None)
@given(
    seed=st.integers(0, 10_000),
    z=st.sampled_from([4, 8, 16]),
    sat_msg=st.sampled_from([15, 31]),
)
def test_random_qc_code_agrees(seed, z, sat_msg):
    rng = np.random.default_rng(seed)
    rows, cols = 3, 6
    base = rng.integers(-1, z, size=(rows, cols))
    # ensure every row has >= 2 entries (valid CN degree)
    for r in range(rows):
        while (base[r] >= 0).sum() < 2:
            base[r, rng.integers(cols)] = rng.integers(z)
    code = make_qc_code(f"fuzz{seed}", base, Z=z)
    llr = np.clip(
        8.0 * rng.normal(-1.0, 0.9, size=(2, code.N)), -31, 31
    ).astype(np.int8)
    spec = LayeredSpec(algo="OMS", iters=4, sat_msg=sat_msg)
    bits = np.asarray(make_layered_decoder(code, spec)(llr)[0])
    refs, _ = decode_oracle(
        code, llr, GoldenParams(algo="OMS", iters=4, sat_msg=sat_msg)
    )
    np.testing.assert_array_equal(bits, refs)


@settings(max_examples=12, deadline=None)
@given(
    seed=st.integers(0, 100_000),
    z=st.sampled_from([8, 12, 16]),
    n_rows=st.integers(1, 3),
)
def test_random_subpass_codes_agree(seed, z, n_rows):
    """Random QC codes WITH repeated block-columns: the sub-pass layer
    machinery (conflict grouping + masked commits + merged writebacks)
    must match a sequential golden of the same schedule."""
    from ldpcgputegra.codes.code import DegreeClass, Layer, LdpcCode, QCRow
    from ldpcgputegra.codes.dvbs2 import _conflict_groups

    rng = np.random.default_rng(seed)
    n_cols = 4
    zz = np.arange(z, dtype=np.int64)[:, None]
    layers, classes, class_idx = [], [], []
    off = 0
    for _ in range(n_rows):
        deg = int(rng.integers(3, 6))
        cols = rng.integers(0, n_cols, size=deg).astype(np.int32)
        shifts = rng.integers(0, z, size=deg).astype(np.int32)
        # forbid identical (col, shift) pairs (same VN twice in a check)
        while len({(int(c), int(s)) for c, s in zip(cols, shifts)}) < deg:
            shifts = rng.integers(0, z, size=deg).astype(np.int32)
        idx = (cols[None, :] * z + (shifts[None, :] + zz) % z).astype(
            np.int32
        )
        groups = _conflict_groups(cols, shifts, z)
        for g in groups:
            layers.append(
                Layer(
                    idx=idx,
                    edge_offset=off,
                    qc=QCRow(
                        cols=cols,
                        shifts=shifts,
                        commit_rows=None if len(groups) == 1 else g,
                    ),
                )
            )
        classes.append(DegreeClass(deg, z))
        class_idx.append(idx)
        off += idx.size
    code = LdpcCode(
        name=f"fz{seed}",
        N=n_cols * z,
        K=n_cols * z - n_rows * z,
        classes=tuple(classes),
        class_idx=tuple(class_idx),
        Z=z,
        layers=tuple(layers),
    )
    # sequential golden of the sub-pass schedule
    gcls, gidx = [], []
    for lay in code.layers:
        sub = (
            lay.idx
            if lay.qc.commit_rows is None
            else lay.idx[lay.qc.commit_rows]
        )
        gcls.append(DegreeClass(sub.shape[1], sub.shape[0]))
        gidx.append(sub)
    gv = LdpcCode(
        name="g", N=code.N, K=code.K, classes=tuple(gcls),
        class_idx=tuple(gidx),
    )
    llr = np.clip(
        8.0 * rng.normal(-0.3, 1.2, size=(4, code.N)), -31, 31
    ).astype(np.int8)
    iters = int(rng.integers(1, 5))
    spec = LayeredSpec(algo="OMS", iters=iters)
    bits = np.asarray(make_layered_decoder(code, spec)(llr)[0])
    refs, _ = decode_oracle(gv, llr, GoldenParams(algo="OMS", iters=iters))
    np.testing.assert_array_equal(bits, refs)


@settings(max_examples=6, deadline=None)
@given(
    seed=st.integers(0, 100_000),
    z=st.sampled_from([8, 16]),
    tp=st.sampled_from([2, 4]),
)
def test_random_subpass_codes_rowshard_agrees(seed, z, tp):
    """The row-sharded decoder on random sub-pass QC codes (repeated
    block-columns, masked commits) must match the single-device layered
    decoder — the worst-case schedule for the per-layer delta-psum merge."""
    from ldpcgputegra.codes.code import DegreeClass, Layer, LdpcCode, QCRow
    from ldpcgputegra.codes.dvbs2 import _conflict_groups
    from ldpcgputegra.parallel.mesh import decode_mesh
    from ldpcgputegra.parallel.rowshard import (
        make_rowsharded_decoder,
        rowshard_supported,
    )

    rng = np.random.default_rng(seed)
    n_cols, n_rows = 4, 2
    zz = np.arange(z, dtype=np.int64)[:, None]
    layers, classes, class_idx = [], [], []
    off = 0
    for _ in range(n_rows):
        deg = int(rng.integers(3, 6))
        cols = rng.integers(0, n_cols, size=deg).astype(np.int32)
        shifts = rng.integers(0, z, size=deg).astype(np.int32)
        while len({(int(c), int(s)) for c, s in zip(cols, shifts)}) < deg:
            shifts = rng.integers(0, z, size=deg).astype(np.int32)
        idx = (cols[None, :] * z + (shifts[None, :] + zz) % z).astype(
            np.int32
        )
        groups = _conflict_groups(cols, shifts, z)
        for g in groups:
            layers.append(
                Layer(
                    idx=idx,
                    edge_offset=off,
                    qc=QCRow(
                        cols=cols,
                        shifts=shifts,
                        commit_rows=None if len(groups) == 1 else g,
                    ),
                )
            )
        classes.append(DegreeClass(deg, z))
        class_idx.append(idx)
        off += idx.size
    code = LdpcCode(
        name=f"fzrs{seed}",
        N=n_cols * z,
        K=n_cols * z - n_rows * z,
        classes=tuple(classes),
        class_idx=tuple(class_idx),
        Z=z,
        layers=tuple(layers),
    )
    assert rowshard_supported(code, tp)
    llr = np.clip(
        8.0 * rng.normal(-0.3, 1.2, size=(3, code.N)), -31, 31
    ).astype(np.int8)
    iters = int(rng.integers(1, 5))
    spec = LayeredSpec(algo="OMS", iters=iters)
    mesh = decode_mesh(n_devices=tp)
    bits_s = np.asarray(make_rowsharded_decoder(code, spec, mesh)(llr)[0])
    bits_1 = np.asarray(make_layered_decoder(code, spec)(llr)[0])
    np.testing.assert_array_equal(bits_s, bits_1)
