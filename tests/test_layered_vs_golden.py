"""Bit-exactness of the batched JAX layered decoder vs the NumPy golden model.

The golden model reproduces the reference's scalar fixed-point oracle
(CDecoder_OMS_fixed_x86.cpp); the JAX decoder must match it bit-for-bit at
equal iteration count on every algorithm variant and schedule.
"""

import numpy as np
import pytest

from ldpcgputegra.codes.registry import load_code, make_random_regular_code
from ldpcgputegra.golden import GoldenParams, decode_golden, decode_oracle
from ldpcgputegra.ops.layered import LayeredSpec, make_layered_decoder


def _random_llrs(n, b, seed=0):
    rng = np.random.default_rng(seed)
    # channel-like int8 LLRs in the quantizer range +/-31, biased negative
    # (all-zero codeword convention: bit 0 -> negative LLR)
    x = rng.normal(-1.0, 0.8, size=(b, n))
    return np.clip(8.0 * x, -31, 31).astype(np.int8)


CASES = [
    ("576x288", "OMS", "pre", "reference"),
    ("576x288", "MS", "post", "reference"),
    ("576x288", "NMS", "post", "reference"),
    ("576x288", "2NMS", "post", "reference"),
    ("1944x972", "OMS", "pre", "reference"),
]


@pytest.mark.parametrize("name,algo,minclamp,schedule", CASES)
def test_qc_decoder_bit_exact(name, algo, minclamp, schedule):
    code = load_code(name)
    B = 4
    llrs = _random_llrs(code.N, B, seed=42)
    spec = LayeredSpec(algo=algo, iters=5, minclamp=minclamp, schedule=schedule)
    dec = make_layered_decoder(code, spec)
    bits, iters = dec(llrs)
    bits = np.asarray(bits)
    assert int(iters) == 5
    gp = GoldenParams(algo=algo, iters=5, minclamp=minclamp)
    refs, _ = decode_oracle(code, llrs, gp)
    np.testing.assert_array_equal(bits, refs)


def test_gather_path_bit_exact_random_code():
    """Non-QC code uses the gather path + reference greedy-run schedule."""
    code = make_random_regular_code(512, 256, 8, seed=3)
    B = 4
    llrs = _random_llrs(code.N, B, seed=7)
    spec = LayeredSpec(algo="OMS", iters=4, schedule="reference")
    dec = make_layered_decoder(code, spec)
    bits, _ = dec(llrs)
    bits = np.asarray(bits)
    gp = GoldenParams(algo="OMS", iters=4)
    refs, _ = decode_oracle(code, llrs, gp)
    np.testing.assert_array_equal(bits, refs)


def test_colored_schedule_matches_its_own_golden_order():
    """The colored schedule is a permuted layered order: verify the JAX
    decoder against a golden model run with the same permuted order."""
    from ldpcgputegra.codes.code import DegreeClass, LdpcCode
    from ldpcgputegra.codes.schedule import build_layers

    code = make_random_regular_code(512, 256, 8, seed=5)
    layers = build_layers(code, "colored")
    # rebuild a code whose reference order IS the colored order
    idx = np.concatenate([l.idx for l in layers], axis=0)
    permuted = LdpcCode(
        name="perm", N=code.N, K=code.K,
        classes=(DegreeClass(8, idx.shape[0]),),
        class_idx=(idx,),
    )
    B = 2
    llrs = _random_llrs(code.N, B, seed=11)
    dec = make_layered_decoder(code, LayeredSpec(algo="OMS", iters=4, schedule="colored"))
    bits = np.asarray(dec(llrs)[0])
    gp = GoldenParams(algo="OMS", iters=4)
    refs, _ = decode_oracle(permuted, llrs, gp)
    np.testing.assert_array_equal(bits, refs)


def test_noiseless_decode_identity():
    """Strong all-zero LLRs decode to the all-zero codeword, instantly."""
    code = load_code("576x288")
    llrs = np.full((3, code.N), -31, dtype=np.int8)
    dec = make_layered_decoder(code, LayeredSpec(algo="OMS", iters=10, early_term=True))
    bits, iters = dec(llrs)
    assert np.asarray(bits).sum() == 0
    assert int(iters) == 1


def test_early_term_matches_fixed_iters_on_convergence():
    """Early termination must not change decoded output (frozen updates)."""
    code = load_code("576x288")
    llrs = _random_llrs(code.N, 8, seed=13)
    d_fix = make_layered_decoder(code, LayeredSpec(algo="OMS", iters=10))
    d_et = make_layered_decoder(code, LayeredSpec(algo="OMS", iters=10, early_term=True))
    bits_fix = np.asarray(d_fix(llrs)[0])
    bits_et, iters = d_et(llrs)
    bits_et = np.asarray(bits_et)
    assert int(iters) <= 10
    np.testing.assert_array_equal(bits_fix, bits_et)


def test_configurable_quantization_ranges():
    """-var/-msg equivalents: narrower saturation changes decode behaviour
    and all paths (XLA, golden NumPy, native oracle) agree bit for bit."""
    code = load_code("576x288")
    # seed 3: an input where the narrow ranges actually change the decode
    llrs = _random_llrs(code.N, 4, seed=3)
    spec = LayeredSpec(algo="OMS", iters=5, sat_var=63, sat_msg=15)
    dec = make_layered_decoder(code, spec)
    bits = np.asarray(dec(llrs)[0])
    gp = GoldenParams(algo="OMS", iters=5, sat_var=63, sat_msg=15)
    refs, _ = decode_oracle(code, llrs, gp)
    np.testing.assert_array_equal(bits, refs)
    # and the range genuinely matters: default-range decode differs
    d2 = make_layered_decoder(code, LayeredSpec(algo="OMS", iters=5))
    assert not np.array_equal(np.asarray(d2(llrs)[0]), bits)


def test_node_major_decode_path():
    """node_major=True skips the interleave transposes (the caller already
    holds node-major data, like the reference's pre-transposed buffers)."""
    code = load_code("576x288")
    spec = LayeredSpec(algo="OMS", iters=4)
    llrs = _random_llrs(code.N, 4, seed=8)
    d_fm = make_layered_decoder(code, spec)
    d_nm = make_layered_decoder(code, spec, node_major=True)
    bits_fm = np.asarray(d_fm(llrs)[0])
    bits_nm = np.asarray(d_nm(llrs.T)[0])
    np.testing.assert_array_equal(bits_fm, bits_nm.T)


@pytest.mark.parametrize("nf,nf2", [(29, 29), (26, 30)])
def test_nms_runtime_factor_bit_exact(nf, nf2):
    """Runtime-parameterized NMS factor (the x86 reference's `-NMS <f>`
    fixed path: VECTOR_MUL + DIV32, default 29 — main_p.cpp:136,293):
    the XLA decoder, the NumPy golden model and the native C++ oracle
    must agree bit-for-bit at non-default factors, for NMS and 2NMS."""
    from ldpcgputegra.golden.native import (
        decode_golden_native,
        native_available,
    )

    code = load_code("576x288")
    llrs = _random_llrs(code.N, 4, seed=77)
    for algo in ("NMS", "2NMS"):
        spec = LayeredSpec(algo=algo, iters=5, minclamp="post",
                           schedule="reference", nms_f=nf, nms_f2=nf2)
        bits = np.asarray(make_layered_decoder(code, spec)(llrs)[0])
        gp = GoldenParams(algo=algo, iters=5, minclamp="post",
                          nms_factor=nf / 32.0, nms_factor2=nf2 / 32.0)
        refs_py = np.empty_like(llrs)
        for i in range(llrs.shape[0]):
            refs_py[i], _ = decode_golden(code, llrs[i], gp)
        np.testing.assert_array_equal(bits, refs_py)
        if native_available():
            refs_nat, _ = decode_golden_native(code, llrs, gp)
            np.testing.assert_array_equal(bits, refs_nat)
    # defaults unchanged: nms_f=24/nms_f2=28 == the old (x*3)>>2/(x*7)>>3
    spec_d = LayeredSpec(algo="2NMS", iters=5, minclamp="post",
                         schedule="reference")
    assert (spec_d.nms_f, spec_d.nms_f2) == (24, 28)


def test_nms_runtime_factor_pallas_interpret():
    """The Pallas QC kernel honors nms_f/nms_f2 (same _f_consts change,
    separate code path) — interpret-mode vs the XLA decoder."""
    code = load_code("576x288")
    llrs = _random_llrs(code.N, 2, seed=78)
    from ldpcgputegra.kernels import make_pallas_decoder

    spec = LayeredSpec(algo="2NMS", iters=4, minclamp="post",
                       schedule="reference", nms_f=29, nms_f2=31)
    bits_x = np.asarray(make_layered_decoder(code, spec)(llrs)[0])
    bits_p = np.asarray(
        make_pallas_decoder(code, spec, interpret=True)(llrs)[0]
    )
    np.testing.assert_array_equal(bits_x, bits_p)
