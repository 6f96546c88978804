"""DPxTP composition on a 2-D (dp, tp) mesh: batch sharded over dp, each
codeword's Tanner graph block-row-sharded over tp — bit-exact vs the
single-device layered decoder, counters psum'd over dp only (bits are
tp-replicated, so a two-axis psum would overcount)."""

import numpy as np
import pytest

from ldpcgputegra.codes.registry import load_code
from ldpcgputegra.ops.layered import LayeredSpec, make_layered_decoder
from ldpcgputegra.parallel.mesh import decode_mesh_2d
from ldpcgputegra.parallel.rowshard import (
    make_dp_tp_decoder,
    rowshard_supported,
)


def _llrs(n, b, seed):
    rng = np.random.default_rng(seed)
    return np.clip(
        8.0 * rng.normal(-1.0, 0.8, size=(b, n)), -31, 31
    ).astype(np.int8)


@pytest.mark.parametrize("dp,tp", [(2, 4), (4, 2)])
def test_dp_tp_bit_exact(dp, tp):
    code = load_code("576x288")
    assert rowshard_supported(code, tp)
    mesh = decode_mesh_2d(dp, tp)
    spec = LayeredSpec(algo="OMS", iters=4)
    step = make_dp_tp_decoder(code, spec, mesh)
    dec_1 = make_layered_decoder(code, spec)
    llr = _llrs(code.N, 2 * dp, seed=11)
    bits_s, it_s, be, fe = step(llr)
    bits_1, it_1 = dec_1(llr)
    np.testing.assert_array_equal(np.asarray(bits_s), np.asarray(bits_1))
    assert int(it_s) == int(it_1) == 4
    # counters match a host-side count against the all-zero codeword
    ref = np.asarray(bits_1).astype(np.int64)
    assert int(be) == int(ref.sum())
    assert int(fe) == int((ref.sum(axis=1) != 0).sum())


def test_dp_tp_early_term_and_ref_bits():
    code = load_code("576x288")
    mesh = decode_mesh_2d(2, 4)
    spec = LayeredSpec(algo="OMS", iters=6, early_term=True)
    step = make_dp_tp_decoder(code, spec, mesh)
    dec_1 = make_layered_decoder(code, spec)
    llr = _llrs(code.N, 4, seed=13)
    bits_s, it_s, be, fe = step(llr)
    bits_1, _ = dec_1(llr)
    np.testing.assert_array_equal(np.asarray(bits_s), np.asarray(bits_1))
    assert int(it_s) <= 6
    # counting against the decoder's own output gives zero errors
    _, _, be0, fe0 = step(llr, ref_bits=np.asarray(bits_1))
    assert int(be0) == 0 and int(fe0) == 0
    # noiseless input converges in one globally-voted iteration
    strong = np.full((2 * 2, code.N), -31, np.int8)
    _, it0, _, _ = step(strong)
    assert int(it0) == 1


@pytest.mark.slow
def test_dp_tp_dvbs2_staircase():
    """DVB-family QC view (deficient circulants + sub-pass layers) under
    the composed mesh: the flagship 2-D topology."""
    code = load_code("16200x7560")
    assert rowshard_supported(code, 4)
    mesh = decode_mesh_2d(2, 4)
    from ldpcgputegra.decoder import make_decoder

    spec = LayeredSpec(algo="OMS", iters=2)
    step = make_dp_tp_decoder(code, spec, mesh, count_errors=False)
    dec_1 = make_decoder(code, spec, backend="xla")  # same QC view
    llr = _llrs(code.N, 2, seed=17)
    bits_s, _ = step(llr)
    bits_1, _ = dec_1(llr)
    np.testing.assert_array_equal(np.asarray(bits_s), np.asarray(bits_1))


def test_rowshard_rejects_2d_mesh():
    """Whole-mesh row sharding on a 2-D mesh would silently merge only a
    fraction of the row slices; it must be rejected loudly."""
    code = load_code("576x288")
    mesh = decode_mesh_2d(2, 4)
    from ldpcgputegra.parallel.rowshard import make_rowsharded_decoder

    with pytest.raises(AssertionError, match="1-D mesh"):
        make_rowsharded_decoder(code, LayeredSpec(algo="OMS", iters=2), mesh)


def test_decode_mesh_2d_requires_enough_devices():
    with pytest.raises(AssertionError, match="devices"):
        decode_mesh_2d(4, 4)  # 16 > the 8 virtual devices
