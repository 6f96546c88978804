"""Fixed-seed regression vectors: every decoder path must reproduce the
committed golden outputs exactly (tools/gen_vectors.py)."""

import glob
import os

import numpy as np
import pytest

from ldpcgputegra.codes.registry import load_code
from ldpcgputegra.ops.layered import LayeredSpec, make_layered_decoder

VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")
# refcheck_*.npz are reference-compiled-oracle vectors (tests/test_refcheck.py)
VECTORS = sorted(
    p
    for p in glob.glob(os.path.join(VEC_DIR, "*.npz"))
    if not os.path.basename(p).startswith("refcheck_")
)


@pytest.mark.parametrize("path", VECTORS, ids=[os.path.basename(p) for p in VECTORS])
def test_vector_xla_decoder(path):
    d = np.load(path)
    code = load_code(str(d["code"]))
    spec = LayeredSpec(
        algo=str(d["algo"]),
        iters=int(d["iters"]),
        minclamp=str(d["minclamp"]),
        offset=int(d["offset"]),
    )
    dec = make_layered_decoder(code, spec)
    bits, _ = dec(d["llr"])
    np.testing.assert_array_equal(np.asarray(bits), d["bits"])


def test_vectors_exist():
    assert len(VECTORS) >= 6
