"""Oracle-loop closure: the golden model vs the reference's ACTUAL code.

Round 1's bit-exactness chain bottomed out in ``golden/decoder.py``, written
by *reading* the reference — a subtly wrong reading would have made every
path agree and every test pass anyway.  These tests close the loop:

* ``tools/refcheck`` compiles the reference's scalar fixed-point OMS decoder
  UNMODIFIED (``code/ldpc_decoder_arm/CDecoder/OMS/CDecoder_OMS_fixed_x86.cpp
  :60-201``) with its own ARM constantes headers for 576x288 and 1944x972;
* ``tests/vectors/refcheck_*.npz`` holds that binary's outputs on fixed-seed
  LLR batches across iteration counts, offsets, early-term on/off, and
  narrow -var/-msg saturations (committed, so the check runs even where the
  reference tree or a compiler is absent);
* the tests assert ``decode_golden`` reproduces those outputs bit for bit,
  and — when g++ and /root/reference are available — rebuild the binary and
  verify the committed vectors are authentic.

Note the ARM PosNoeudsVariable tables differ from the gpu_fixed ones the
registry imports (different H instance for the same N x K), so the codes
here are parsed straight from the ARM headers (``parse_arm_code``).
"""

import glob
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from refcheck.build import (  # noqa: E402
    compiler_available,
    parse_arm_code,
    reference_available,
)

from ldpcgputegra.golden import GoldenParams  # noqa: E402
from ldpcgputegra.golden.decoder import decode_golden  # noqa: E402

VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")
VECTORS = sorted(
    p for p in glob.glob(os.path.join(VEC_DIR, "refcheck_*.npz"))
    if "_sse_" not in os.path.basename(p)  # SSE vectors have their own tests
)
_CODES = [os.path.basename(p)[len("refcheck_"):-len(".npz")] for p in VECTORS]


def _params(it, off, et, sv, sm):
    return GoldenParams(
        algo="OMS", iters=int(it), offset=int(off), early_term=bool(et),
        minclamp="pre", sat_var=int(sv), sat_msg=int(sm),
    )


def test_refcheck_vectors_exist():
    assert set(_CODES) >= {"576x288", "1944x972"}


def _code_from_npz(d, name):
    """Rebuild the ARM-header code from the structure embedded in the npz,
    so this check is self-contained (runs without /root/reference)."""
    from ldpcgputegra.codes.code import LdpcCode

    classes = list(zip(d["class_degs"].tolist(), d["class_counts"].tolist()))
    return LdpcCode.from_edges(
        f"arm-{name}", int(d["code_N"]), None, classes, d["edges"],
        detect_qc=False,
    )


@pytest.mark.parametrize("name", _CODES)
def test_golden_matches_reference_vectors(name):
    d = np.load(os.path.join(VEC_DIR, f"refcheck_{name}.npz"))
    code = _code_from_npz(d, name)
    llr = d["llr"]
    for ci, cfg in enumerate(d["configs"]):
        ref = d[f"bits_{ci}"]
        gp = _params(*cfg)
        got = np.stack(
            [decode_golden(code, llr[b], gp)[0] for b in range(len(llr))]
        )
        np.testing.assert_array_equal(
            got.astype(np.int8), ref,
            err_msg=f"{name} config {cfg.tolist()} diverges from the "
            "compiled reference decoder",
        )


@pytest.mark.skipif(
    not (reference_available() and compiler_available()),
    reason="needs g++ and /root/reference",
)
def test_committed_vectors_are_authentic(tmp_path):
    """Rebuild the reference binary and regenerate one config end-to-end."""
    from refcheck.build import build_oracle, run_oracle

    name = "576x288"
    d = np.load(os.path.join(VEC_DIR, f"refcheck_{name}.npz"))
    # the embedded code structure must equal the ARM header's
    ref_code = parse_arm_code(name)
    emb_code = _code_from_npz(d, name)
    assert emb_code.N == ref_code.N
    for a, b in zip(emb_code.class_idx, ref_code.class_idx):
        np.testing.assert_array_equal(a, b)
    binary = build_oracle(name, str(tmp_path))
    cfg = d["configs"][2]  # iters=10 off=1 et=0 full-range
    ref = run_oracle(
        binary, d["llr"], iters=int(cfg[0]), offset=int(cfg[1]),
        early=bool(cfg[2]), sat_var=int(cfg[3]), sat_msg=int(cfg[4]),
    )
    np.testing.assert_array_equal(ref, d["bits_2"])


NMS_VECTORS = sorted(
    glob.glob(os.path.join(VEC_DIR, "refcheck_nms_sse_*.npz"))
)
_NMS_CODES = [
    os.path.basename(p)[len("refcheck_nms_sse_"):-len(".npz")]
    for p in NMS_VECTORS
]


def test_nms_refcheck_vectors_exist():
    assert set(_NMS_CODES) >= {"576x288", "1944x972"}


@pytest.mark.parametrize("name", _NMS_CODES)
def test_golden_nms_matches_reference_sse_vectors(name):
    """The runtime-factor NMS semantics vs the reference's COMPILED SSE
    NMS decoder (CDecoder_NMS_fixed_SSE.cpp built unmodified): factor f/32
    via VECTOR_MUL+DIV32, msg-clamp before the min reduction ('pre'),
    across iteration counts and factors 24/29/31 (CUDA default / x86
    default / near-MS).  Vectors: tools/refcheck/gen_nms_vectors.py."""
    d = np.load(os.path.join(VEC_DIR, f"refcheck_nms_sse_{name}.npz"))
    code = _code_from_npz(d, name)
    llr = d["llr"]
    for ci, (iters, factor) in enumerate(d["configs"]):
        gp = GoldenParams(
            algo="NMS", iters=int(iters), minclamp="pre",
            nms_factor=int(factor) / 32.0, early_term=False,
        )
        got = np.stack(
            [decode_golden(code, llr[b], gp)[0] for b in range(len(llr))]
        )
        np.testing.assert_array_equal(
            got.astype(np.int8), d[f"bits_{ci}"],
            err_msg=f"{name} iters={iters} factor={factor} diverges from "
            "the compiled reference SSE NMS decoder",
        )


@pytest.mark.skipif(
    not (reference_available() and compiler_available()),
    reason="needs g++ and /root/reference",
)
def test_committed_nms_vectors_are_authentic(tmp_path):
    """Rebuild the SSE NMS reference binary and regenerate one config."""
    from refcheck.build import (
        build_nms_sse_oracle,
        parse_x86_code,
        run_nms_sse_oracle,
    )

    name = "576x288"
    d = np.load(os.path.join(VEC_DIR, f"refcheck_nms_sse_{name}.npz"))
    ref_code = parse_x86_code(name)
    emb_code = _code_from_npz(d, name)
    assert emb_code.N == ref_code.N
    for a, b in zip(emb_code.class_idx, ref_code.class_idx):
        np.testing.assert_array_equal(a, b)
    binary = build_nms_sse_oracle(name, str(tmp_path))
    iters, factor = d["configs"][3]  # iters=10 factor=29 (x86 default)
    ref = run_nms_sse_oracle(binary, d["llr"], iters=int(iters),
                             factor=int(factor))
    np.testing.assert_array_equal(ref, d["bits_3"])


OMS_SSE_VECTORS = sorted(
    glob.glob(os.path.join(VEC_DIR, "refcheck_oms_sse_*.npz"))
)
_OMS_SSE_CODES = [
    os.path.basename(p)[len("refcheck_oms_sse_"):-len(".npz")]
    for p in OMS_SSE_VECTORS
]


@pytest.mark.parametrize("name", _OMS_SSE_CODES)
def test_golden_oms_matches_reference_sse_vectors(name):
    """The golden OMS semantics vs the reference's COMPILED SSE OMS
    decoder (CDecoder_OMS_fixed_SSE.cpp built unmodified; the vsubus
    offset-with-underflow-to-zero SIMD form) across iters x offsets.
    The scalar-OMS refcheck pins the x86 scalar decoder; this pins the
    production SIMD one (D8).  Vectors: tools/refcheck/gen_sse_vectors.py."""
    d = np.load(os.path.join(VEC_DIR, f"refcheck_oms_sse_{name}.npz"))
    code = _code_from_npz(d, name)
    llr = d["llr"]
    for ci, (iters, offset) in enumerate(d["configs"]):
        gp = GoldenParams(
            algo="OMS", iters=int(iters), offset=int(offset),
            minclamp="pre", early_term=False,
        )
        got = np.stack(
            [decode_golden(code, llr[b], gp)[0] for b in range(len(llr))]
        )
        np.testing.assert_array_equal(
            got.astype(np.int8), d[f"bits_{ci}"],
            err_msg=f"{name} iters={iters} offset={offset} diverges from "
            "the compiled reference SSE OMS decoder",
        )
