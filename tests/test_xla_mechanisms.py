"""The XLA decode path against the golden oracle, mechanism by mechanism.

Each case runs the smallest code that exercises one mechanism of the
layered decoder, under every min-sum variant, and requires the decoded
bits and the reported iteration count to equal the golden oracle's (run in
the decoder's own schedule order, ``golden.decode_scheduled``).
"""

import numpy as np
import pytest
from helpers import dup_col_code, llrs, tiny_staircase_view

from ldpcgputegra.codes.registry import (
    load_code,
    make_random_qc_code,
    make_random_regular_code,
)
from ldpcgputegra.golden import decode_scheduled, params_for
from ldpcgputegra.ops.layered import LayeredSpec, make_layered_decoder


def mechanism_case(mech):
    """(code, LayeredSpec overrides, batch, llr sigma) for one mechanism."""
    if mech == "subpass":  # repeated block-columns: sub-pass commits
        return dup_col_code(), {"iters": 3}, 16, 0.8
    if mech == "deficient":  # masked edge of a deficient circulant
        view = tiny_staircase_view()
        assert any(l.qc.mask_edge is not None for l in view.layers)
        return view, {"iters": 4}, 16, 0.7
    if mech == "oddz":  # Z = 9: no power-of-two row layout
        code = make_random_qc_code(16, 8, 5, Z=9, seed=9)
        return code, {"iters": 4}, 16, 0.9
    if mech == "colored":  # non-QC code, colored schedule
        code = make_random_regular_code(512, 256, 8, seed=5)
        return code, {"iters": 4, "schedule": "colored"}, 8, 0.8
    if mech == "ragged":  # a batch that is no multiple of any tile
        return load_code("576x288"), {"iters": 3}, 37, 0.8
    if mech == "et_freeze":  # per-frame early termination + counts
        return (load_code("576x288"), {"iters": 10, "early_term": True},
                24, 0.7)
    raise ValueError(mech)


MECHANISMS = ["subpass", "deficient", "oddz", "colored", "ragged",
              "et_freeze"]
VARIANTS = [("MS", "post"), ("OMS", "pre"), ("NMS", "post"),
            ("2NMS", "post")]


@pytest.mark.parametrize("algo,minclamp", VARIANTS)
@pytest.mark.parametrize("mech", MECHANISMS)
def test_xla_matches_golden(mech, algo, minclamp):
    code, kw, batch, sigma = mechanism_case(mech)
    spec = LayeredSpec(algo=algo, minclamp=minclamp, **kw)
    llr = llrs(code.N, batch, seed=MECHANISMS.index(mech), sigma=sigma)
    bits, iters = make_layered_decoder(code, spec)(llr)
    ref, used = decode_scheduled(code, llr, params_for(spec), spec.schedule)
    np.testing.assert_array_equal(np.asarray(bits), ref)
    assert int(iters) == int(used.max())
    if mech == "et_freeze":
        # the batch must mix early and late convergence to test the freeze
        assert used.min() < used.max()


def test_subpass_layers_xla():
    """Sub-pass schedule vs a golden that runs only committed rows."""
    code = dup_col_code()
    llr = llrs(code.N, 64, seed=15)
    spec = LayeredSpec(algo="OMS", iters=3)
    bits = np.asarray(make_layered_decoder(code, spec)(llr)[0])
    ref, _ = decode_scheduled(code, llr, params_for(spec))
    np.testing.assert_array_equal(bits, ref)
