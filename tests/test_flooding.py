"""Flooding-schedule decoder: bit-exact vs its NumPy oracle + channel
quality sanity."""

import numpy as np
import pytest

from ldpcgputegra.codes.registry import load_code, make_random_regular_code
from ldpcgputegra.ops.flooding import flooding_golden, make_flooding_decoder
from ldpcgputegra.ops.layered import LayeredSpec


def _llrs(n, b, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(
        8.0 * rng.normal(-1.0, 0.8, size=(b, n)), -31, 31
    ).astype(np.int8)


@pytest.mark.parametrize("algo,minclamp", [("OMS", "pre"), ("MS", "post")])
def test_flooding_bit_exact_vs_golden(algo, minclamp):
    code = load_code("576x288")
    spec = LayeredSpec(algo=algo, iters=4, minclamp=minclamp)
    dec = make_flooding_decoder(code, spec)
    llr = _llrs(code.N, 3, seed=11)
    bits = np.asarray(dec(llr)[0])
    for b in range(3):
        ref = flooding_golden(code, llr[b], spec)
        np.testing.assert_array_equal(bits[b], ref, err_msg=f"frame {b}")


def test_flooding_nonqc_code():
    code = make_random_regular_code(512, 256, 8, seed=3)
    spec = LayeredSpec(algo="OMS", iters=4)
    dec = make_flooding_decoder(code, spec)
    llr = _llrs(code.N, 2, seed=7)
    bits = np.asarray(dec(llr)[0])
    for b in range(2):
        ref = flooding_golden(code, llr[b], spec)
        np.testing.assert_array_equal(bits[b], ref)


def test_flooding_corrects_errors():
    """~2x layered iterations reaches a comparable operating point."""
    code = load_code("1944x972")
    dec = make_flooding_decoder(code, LayeredSpec(algo="OMS", iters=20))
    rng = np.random.default_rng(0)
    llr = np.clip(
        8.0 * rng.normal(-1.0, 0.62, size=(16, code.N)), -31, 31
    ).astype(np.int8)
    bits = np.asarray(dec(llr)[0])
    assert bits.sum() < (llr > 0).sum() / 100


def test_flooding_early_term():
    code = load_code("576x288")
    d_f = make_flooding_decoder(code, LayeredSpec(algo="OMS", iters=8))
    d_e = make_flooding_decoder(
        code, LayeredSpec(algo="OMS", iters=8, early_term=True)
    )
    llr = _llrs(code.N, 8, seed=5)
    bf = np.asarray(d_f(llr)[0])
    be, used = d_e(llr)
    np.testing.assert_array_equal(bf, np.asarray(be))
    assert int(used) <= 8
    # noiseless input converges immediately
    strong = np.full((2, code.N), -31, np.int8)
    _, used0 = d_e(strong)
    assert int(used0) == 1


def test_flooding_on_staircase_code_valid_codeword():
    """Regression: make_decoder(schedule='flooding') on a DVB-family
    staircase code must decode against the ORIGINAL column order.  Round 1
    applied effective_code()'s QC view (a column permutation) before the
    flooding dispatch, so a valid noiseless codeword decoded with thousands
    of bit errors (masked by all-zero-codeword sims)."""
    from ldpcgputegra.channel.encoder import make_encoder
    from ldpcgputegra.decoder import make_decoder

    code = load_code("16200x7560")
    enc = make_encoder(code, "staircase")
    rng = np.random.default_rng(42)
    info = rng.integers(0, 2, size=(2, code.K), dtype=np.uint8)
    coded = enc.encode(info)
    llr = np.where(coded != 0, 31, -31).astype(np.int8)
    dec = make_decoder(code, LayeredSpec(algo="OMS", iters=4, schedule="flooding"))
    bits = np.asarray(dec(llr)[0])
    np.testing.assert_array_equal(bits, coded.astype(np.uint8))
