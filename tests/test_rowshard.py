"""Tanner-graph (block-row) sharding: one codeword decoded across the
8-device virtual mesh, bit-exact vs the single-device layered decoder.

This is the TP analogue SURVEY §2.5/§7 designs for the DVB-S2 codes: APP
replicated, each device owns Z/D rows of every QC block-row, deltas merge
via one psum per layer, messages stay device-local."""

import numpy as np
import pytest

from ldpcgputegra.codes.registry import load_code
from ldpcgputegra.ops.layered import LayeredSpec, make_layered_decoder
from ldpcgputegra.parallel.mesh import decode_mesh
from ldpcgputegra.parallel.rowshard import (
    make_rowsharded_decoder,
    rowshard_supported,
)


def _llrs(n, b, seed):
    rng = np.random.default_rng(seed)
    return np.clip(
        8.0 * rng.normal(-1.0, 0.8, size=(b, n)), -31, 31
    ).astype(np.int8)


@pytest.mark.parametrize("name,devs", [("576x288", 8), ("2304x1152", 4)])
def test_rowshard_bit_exact_qc(name, devs):
    code = load_code(name)
    assert rowshard_supported(code, devs)
    mesh = decode_mesh(n_devices=devs)
    spec = LayeredSpec(algo="OMS", iters=4)
    dec_s = make_rowsharded_decoder(code, spec, mesh)
    dec_1 = make_layered_decoder(code, spec)
    llr = _llrs(code.N, 2, seed=3)
    bits_s, it_s = dec_s(llr)
    bits_1, it_1 = dec_1(llr)
    np.testing.assert_array_equal(np.asarray(bits_s), np.asarray(bits_1))
    assert int(it_s) == int(it_1) == 4


@pytest.mark.slow
def test_rowshard_early_term_matches():
    code = load_code("576x288")
    mesh = decode_mesh(n_devices=8)
    spec = LayeredSpec(algo="OMS", iters=6, early_term=True)
    dec_s = make_rowsharded_decoder(code, spec, mesh)
    dec_1 = make_layered_decoder(code, spec)
    llr = _llrs(code.N, 3, seed=5)
    bits_s, it_s = dec_s(llr)
    bits_1, _ = dec_1(llr)
    np.testing.assert_array_equal(np.asarray(bits_s), np.asarray(bits_1))
    assert int(it_s) <= 6
    # noiseless input: one iteration, globally voted
    strong = np.full((2, code.N), -31, np.int8)
    _, it0 = dec_s(strong)
    assert int(it0) == 1


@pytest.mark.slow
def test_rowshard_dvbs2_staircase_one_frame():
    """The flagship target: ONE DVB-family frame split across 8 devices
    (QC view with deficient circulants + sub-pass layers), bit-exact."""
    code = load_code("16200x7560")
    assert rowshard_supported(code, 8)
    mesh = decode_mesh(n_devices=8)
    from ldpcgputegra.decoder import make_decoder

    spec = LayeredSpec(algo="OMS", iters=2)
    dec_s = make_rowsharded_decoder(code, spec, mesh)
    dec_1 = make_decoder(code, spec, backend="xla")  # same QC view
    llr = _llrs(code.N, 1, seed=7)
    bits_s, _ = dec_s(llr)
    bits_1, _ = dec_1(llr)
    np.testing.assert_array_equal(np.asarray(bits_s), np.asarray(bits_1))
