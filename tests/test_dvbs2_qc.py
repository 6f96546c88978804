"""DVB-S2 QC-ification: structure, bit-exactness, and decode quality.

The QC view changes the layered *order* (q block-rows of Z=360 parallel
checks instead of the natural staircase order), so validation compares
against a golden model run with the same permuted schedule — including the
deficient-circulant handling, which must be exactly an absent edge.
"""

import numpy as np
import pytest

from ldpcgputegra.codes.code import DegreeClass, LdpcCode
from ldpcgputegra.codes.dvbs2 import is_staircase, to_qc_form
from ldpcgputegra.codes.registry import load_code
from ldpcgputegra.decoder import effective_code, make_decoder
from ldpcgputegra.golden import GoldenParams, decode_oracle
from ldpcgputegra.ops.layered import LayeredSpec, make_layered_decoder


def _golden_view(qc: LdpcCode) -> LdpcCode:
    """A ragged code whose reference order IS the QC schedule — including
    sub-pass commit order — with the deficient edge truly absent (for
    oracle validation)."""
    classes = []
    class_idx = []
    for lay in qc.layers:
        idx = lay.idx
        if lay.qc.commit_rows is not None:
            idx = idx[lay.qc.commit_rows]
        me = lay.qc.mask_edge
        has_row0 = (
            lay.qc.commit_rows is None or 0 in lay.qc.commit_rows.tolist()
        )
        if me is None or not has_row0:
            classes.append(DegreeClass(idx.shape[1], idx.shape[0]))
            class_idx.append(idx)
        else:
            # this entry commits check 0, whose deficient edge is absent
            first = np.delete(idx[0], me)[None, :]
            classes.append(DegreeClass(first.shape[1], 1))
            class_idx.append(first.astype(np.int32))
            classes.append(DegreeClass(idx.shape[1], idx.shape[0] - 1))
            class_idx.append(idx[1:])
    return LdpcCode(
        name=qc.name + "-golden",
        N=qc.N,
        K=qc.K,
        classes=tuple(classes),
        class_idx=tuple(class_idx),
    )


def test_qc_form_structure():
    code = load_code("16200x7560")
    assert is_staircase(code)
    qc = to_qc_form(code)
    assert qc.Z == 360
    assert len(qc.layers) == qc.n_checks // 360
    assert sum(1 for l in qc.layers if l.qc.mask_edge is not None) == 1
    assert qc.col_perm is not None
    # permutation is a bijection fixing the info part
    assert sorted(qc.col_perm.tolist()) == list(range(qc.N))
    assert (qc.col_perm[: qc.K] == np.arange(qc.K)).all()


def test_effective_code_uses_qc_view():
    code = load_code("16200x7560")
    eff = effective_code(code)
    assert eff.Z == 360 and eff.col_perm is not None
    # non-staircase codes pass through
    c2 = load_code("1944x972")
    assert effective_code(c2) is c2


@pytest.mark.parametrize("name", ["16200x7560", "16200x10800"])
def test_qc_decode_bit_exact_vs_permuted_golden(name):
    code = load_code(name)
    qc = to_qc_form(code)
    dec = make_layered_decoder(qc, LayeredSpec(algo="OMS", iters=3))
    rng = np.random.default_rng(4)
    B = 4
    llr = np.clip(
        8.0 * rng.normal(-1.0, 0.7, size=(B, code.N)), -31, 31
    ).astype(np.int8)
    bits = np.asarray(dec(llr)[0])
    # golden on the permuted schedule, in permuted column space
    gv = _golden_view(qc)
    perm = qc.col_perm
    inv = np.empty(code.N, np.int64)
    inv[perm] = np.arange(code.N)
    refs, _ = decode_oracle(gv, llr[:, perm], GoldenParams(algo="OMS", iters=3))
    refs = refs[:, inv]
    np.testing.assert_array_equal(bits, refs)


def test_qc_decode_corrects_errors():
    """End-to-end: the QC view decodes AWGN noise on a DVB frame."""
    code = load_code("16200x7560")
    dec = make_decoder(code, LayeredSpec(algo="OMS", iters=8))
    rng = np.random.default_rng(0)
    llr = np.clip(
        8.0 * rng.normal(-1.0, 0.55, size=(16, code.N)), -31, 31
    ).astype(np.int8)
    bits = np.asarray(dec(llr)[0])
    ch_err = (llr > 0).sum()
    assert bits.sum() < ch_err / 100


def test_derived_16200x10800_code_end_to_end():
    """The H derived from the reference's encoder table (which shipped with
    no matrix) loads, QC-ifies, decodes its own encoder's frames, and
    corrects channel errors."""
    from ldpcgputegra.channel.encoder import make_encoder

    code = load_code("16200x10800")
    assert (code.N, code.K, code.n_checks) == (16200, 10800, 5400)
    # its block-rows repeat block-columns (degree-13 VNs): the QC view
    # must split those into masked sub-pass layers
    eff = effective_code(code)
    assert eff.Z == 360
    assert sum(1 for l in eff.layers if l.qc.commit_rows is not None) > 0
    enc = make_encoder(code, "table")
    rng = np.random.default_rng(2)
    info = rng.integers(0, 2, size=(4, code.K)).astype(np.int8)
    coded = enc.encode(info)
    llr = np.clip(
        8.0 * ((2 * coded - 1) + 0.5 * rng.normal(size=coded.shape)),
        -31, 31,
    ).astype(np.int8)
    dec = make_decoder(code, LayeredSpec(algo="OMS", iters=20))
    bits = np.asarray(dec(llr)[0])
    ch = (llr * (2 * coded - 1) < 0).sum()
    assert ch > 100
    assert (bits != coded).sum() == 0  # full correction, no divergence


@pytest.mark.slow
@pytest.mark.slow
def test_qc_decode_bit_exact_64800():
    """The flagship DVB-S2 64800x32400 QC view (with sub-pass splits) is
    bit-exact vs the permuted-order golden oracle."""
    code = load_code("64800x32400")
    qc = to_qc_form(code)
    assert sum(1 for l in qc.layers if l.qc.commit_rows is not None) > 0
    dec = make_layered_decoder(qc, LayeredSpec(algo="OMS", iters=3))
    rng = np.random.default_rng(6)
    B = 2
    llr = np.clip(
        8.0 * rng.normal(-1.0, 0.7, size=(B, code.N)), -31, 31
    ).astype(np.int8)
    bits = np.asarray(dec(llr)[0])
    gv = _golden_view(qc)
    perm = qc.col_perm
    inv = np.empty(code.N, np.int64)
    inv[perm] = np.arange(code.N)
    refs, _ = decode_oracle(
        gv, llr[:, perm], GoldenParams(algo="OMS", iters=3)
    )
    np.testing.assert_array_equal(bits, refs[:, inv])
