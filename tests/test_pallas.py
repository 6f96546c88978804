"""The fused Pallas-Triton QC kernel, bit-exact against the golden model.

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``),
which checks its semantics: indexing, masks, the layer and iteration loops,
early termination.  ``test_kernel_compiled_on_gpu`` runs the compiled
kernel and ``test_kernel_z360_tiles_and_warps_on_gpu`` runs it at every
tile and warp count it may take on the Z=360 views; both need a GPU
(``gpu`` marker; ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` on a
machine with one).
"""

import jax
import numpy as np
import pytest
from helpers import dup_col_code, llrs, tiny_staircase_view

from ldpcgputegra.codes.registry import load_code, make_random_qc_code
from ldpcgputegra.decoder import effective_code, make_decoder
from ldpcgputegra.golden import decode_scheduled, params_for
from ldpcgputegra.golden.decoder import GoldenParams, decode_golden
from ldpcgputegra.kernels import (
    make_pallas_decoder,
    pallas_layered,
    pallas_supported,
)
from ldpcgputegra.kernels.pallas_layered import (
    pick_batch_tile,
    pick_num_warps,
    pick_rows,
)
from ldpcgputegra.ops.layered import LayeredSpec, make_layered_decoder


def _pallas(code, spec, **kw):
    return make_pallas_decoder(code, spec, interpret=True, **kw)


@pytest.mark.parametrize("algo,minclamp", [("OMS", "pre"), ("NMS", "post")])
def test_pallas_bit_exact_vs_golden(algo, minclamp):
    code = load_code("576x288")
    spec = LayeredSpec(algo=algo, iters=3, minclamp=minclamp)
    assert pallas_supported(code, spec)
    llr = llrs(code.N, 32, seed=42)
    bits, _ = _pallas(code, spec, batch_tile=16)(llr)
    bits = np.asarray(bits)
    gp = GoldenParams(algo=algo, iters=3, minclamp=minclamp)
    for b in range(3):
        ref, _ = decode_golden(code, llr[b], gp)
        np.testing.assert_array_equal(bits[b], ref, err_msg=f"frame {b}")


def test_pallas_early_term_matches_fixed():
    """ET freezes converged codewords; output must equal the fixed-iter
    path wherever the fixed path also stays converged."""
    code = load_code("576x288")
    llr = llrs(code.N, 32, seed=9)
    d_e = _pallas(code, LayeredSpec(algo="OMS", iters=4, early_term=True),
                  batch_tile=16)
    d_x = make_layered_decoder(
        code, LayeredSpec(algo="OMS", iters=4, early_term=True))
    be, ie = d_e(llr)
    bx, ix = d_x(llr)
    np.testing.assert_array_equal(np.asarray(be), np.asarray(bx))
    assert int(ie) == int(ix)


def test_pallas_matches_xla_path():
    """Pallas and the XLA roll path implement the same schedule."""
    code = load_code("576x288")
    spec = LayeredSpec(algo="2NMS", iters=3, minclamp="post")
    llr = llrs(code.N, 32, seed=5)
    p = _pallas(code, spec, batch_tile=16)
    x = make_layered_decoder(code, spec)
    np.testing.assert_array_equal(np.asarray(p(llr)[0]), np.asarray(x(llr)[0]))


def test_pallas_et_reports_iterations_used():
    """ET counts executed iterations; noiseless input converges at 1."""
    code = load_code("576x288")
    dec = _pallas(code, LayeredSpec(algo="OMS", iters=10, early_term=True),
                  batch_tile=16)
    strong = np.full((16, code.N), -31, np.int8)
    _, iters = dec(strong)
    assert int(iters) == 1
    _, iters2 = dec(llrs(code.N, 16, seed=3))
    assert 1 <= int(iters2) <= 10


def test_pallas_odd_z_padded_layout_bit_exact():
    """Z = 12 and Z = 9 pad to a power-of-two row chunk whose spare rows
    are masked off; bit-exact vs the XLA path with and without ET."""
    for z in (12, 9):
        code = make_random_qc_code(16, 8, 5, Z=z, seed=9)
        llr = llrs(code.N, 24, seed=3, sigma=0.9)
        for et in (False, True):
            spec = LayeredSpec(algo="OMS", iters=5, early_term=et)
            b_ref, it_ref = make_layered_decoder(code, spec)(llr)
            b_pl, it_pl = _pallas(code, spec, batch_tile=8)(llr)
            np.testing.assert_array_equal(np.asarray(b_ref), np.asarray(b_pl))
            assert int(it_ref) == int(it_pl)


def test_pallas_emit_mask_matches_true_syndrome():
    """emit_mask through make_decoder: the third output is the TRUE
    per-frame syndrome of the output hard decisions."""
    from ldpcgputegra.decoder.twophase import syndrome_fn
    from ldpcgputegra.golden.decoder import syndrome_ok

    code = load_code("576x288")
    spec = LayeredSpec(algo="OMS", iters=4)
    dec = make_decoder(code, spec, backend="pallas", interpret=True,
                       emit_mask=True)
    # moderate noise: the batch must contain both kinds of frames
    llr = llrs(code.N, 48, seed=21, sigma=0.75)
    bits, _, ok = dec(llr)
    bits, ok = np.asarray(bits), np.asarray(ok)
    assert ok.shape == (48,) and ok.dtype == np.bool_
    assert 0 < ok.sum() < 48, "test needs a mixed batch"
    np.testing.assert_array_equal(ok, np.asarray(syndrome_fn(code)(bits)))
    gp = GoldenParams(algo="OMS", iters=4)
    for b in range(8):
        ref, _ = decode_golden(code, llr[b], gp)
        np.testing.assert_array_equal(bits[b], ref, err_msg=f"frame {b}")
        assert bool(ok[b]) == syndrome_ok(code, bits[b]), f"frame {b}"


def test_pallas_emit_mask_ragged_batch():
    """Codeword padding must be sliced off every output."""
    code = load_code("576x288")
    dec = make_decoder(code, LayeredSpec(algo="OMS", iters=2),
                       backend="pallas", interpret=True, emit_mask=True,
                       batch_tile=16)
    bits, _, ok = dec(llrs(code.N, 21, seed=3))
    assert np.asarray(bits).shape == (21, code.N)
    assert np.asarray(ok).shape == (21,)


def test_pallas_emit_mask_subpass_oddz():
    """emit_mask on a code with sub-pass layers and odd Z: ok equals
    syndrome_fn of the returned bits, and the bits equal the golden
    model's."""
    from ldpcgputegra.decoder.twophase import syndrome_fn

    code = dup_col_code(z=9)
    spec = LayeredSpec(algo="OMS", iters=3)
    dec = make_decoder(code, spec, backend="pallas", interpret=True,
                       emit_mask=True, batch_tile=8)
    llr = llrs(code.N, 40, seed=7, sigma=1.0)
    bits, _, ok = dec(llr)
    bits, ok = np.asarray(bits), np.asarray(ok)
    np.testing.assert_array_equal(ok, np.asarray(syndrome_fn(code)(bits)))
    assert 0 < ok.sum() < 40  # mixed batch: the pin is non-trivial
    ref, _ = decode_scheduled(code, llr, params_for(spec))
    np.testing.assert_array_equal(bits, ref)


@pytest.mark.parametrize("et", [False, True])
def test_pallas_deficient_circulant_and_subpass_view(et):
    """The QC view of a staircase code (column permutation, a deficient
    circulant and sub-pass layers) against the golden model."""
    code = tiny_staircase_view()
    spec = LayeredSpec(algo="OMS", iters=6, early_term=et)
    llr = llrs(code.N, 24, seed=2, sigma=0.7)
    bits, it = _pallas(code, spec, batch_tile=8)(llr)
    ref, used = decode_scheduled(code, llr, params_for(spec))
    np.testing.assert_array_equal(np.asarray(bits), ref)
    assert int(it) == int(used.max())


def test_pallas_multi_tile_ragged_batch():
    """Several programs, the last one padded: every frame is golden."""
    code = load_code("576x288")
    spec = LayeredSpec(algo="MS", iters=3, minclamp="post")
    llr = llrs(code.N, 37, seed=17)
    bits, it = _pallas(code, spec, batch_tile=8)(llr)
    ref, _ = decode_scheduled(code, llr, params_for(spec))
    np.testing.assert_array_equal(np.asarray(bits), ref)
    assert int(it) == 3


def test_tile_and_row_picks():
    """Row chunks are powers of two padding Z by at most 20%; tiles are
    at most 2048 elements and leave at least 32 programs where the batch
    allows (the picks tuned on the card)."""
    for z, r in ((360, 128), (96, 32), (81, 32), (24, 8), (8, 8)):
        assert pick_rows(z) == r
        assert -(-z // r) * r <= 1.2 * z
    assert pick_batch_tile(8192, 32) == 64  # 2304x1152 / 1944x972
    assert pick_batch_tile(1024, 128) == 16  # 64800x32400-dvbs2
    assert pick_batch_tile(256, 128) == 8  # 64800x21600
    assert pick_batch_tile(128, 32) == 8
    assert pick_batch_tile(1 << 20, 8) == 64
    assert (pick_num_warps(32, 64), pick_num_warps(128, 8),
            pick_num_warps(8, 8)) == (8, 8, 4)


def test_pallas_refuses_cpu_without_interpret():
    """An explicit kernel on a machine with no GPU raises; it never falls
    into the interpreter by itself."""
    code = load_code("576x288")
    with pytest.raises(RuntimeError, match="no GPU"):
        make_pallas_decoder(code, LayeredSpec())
    with pytest.raises(RuntimeError, match="no GPU"):
        make_decoder(code, LayeredSpec(), backend="pallas")


@pytest.mark.gpu
def test_kernel_compiled_on_gpu(gpu):
    """The compiled kernel at a real width equals the XLA path bit for bit,
    with and without early termination."""
    code = load_code("1944x972")
    llr = llrs(code.N, 1024, seed=1, sigma=0.75)
    for et in (False, True):
        spec = LayeredSpec(algo="OMS", iters=10, early_term=et)
        b_k, it_k = make_decoder(code, spec, backend="pallas")(llr)
        b_x, it_x = make_decoder(code, spec, backend="xla")(llr)
        np.testing.assert_array_equal(np.asarray(b_k), np.asarray(b_x))
        assert int(it_k) == int(it_x)
    assert jax.default_backend() == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("name,sigma", [("64800x21600", 1.1),
                                        ("64800x32400-dvbs2", 0.9)])
def test_kernel_z360_tiles_and_warps_on_gpu(gpu, name, sigma, monkeypatch):
    """The compiled kernel on the Z=360 QC views (sub-pass layers; column
    permutation and a deficient circulant) at tiles of 4, 8 and 16
    codewords with 4 and 8 warps, each bit-exact with the golden oracle
    in the view's schedule and with its iteration count.  A tile or warp
    count that alone gave wrong bits would point to a hazard between the
    program's threads, which the interpreter cannot show."""
    code = load_code(name)
    spec = LayeredSpec(algo="OMS", iters=10)
    llr = llrs(code.N, 256, seed=4, sigma=sigma)
    ref, used = decode_scheduled(code, llr, params_for(spec))
    view = effective_code(code)
    for tb in (4, 8, 16):
        for nw in (4, 8):
            monkeypatch.setattr(pallas_layered, "pick_num_warps",
                                lambda rows, tb, nw=nw: nw)
            dec = make_pallas_decoder(view, spec, batch_tile=tb)
            bits, it = dec(llr)
            np.testing.assert_array_equal(np.asarray(bits), ref,
                                          err_msg=f"tb={tb} nw={nw}")
            assert int(it) == int(used.max())


def test_pallas_splits_batches_past_the_offset_limit(monkeypatch):
    """A batch whose message buffer would pass the 32-bit offset limit is
    decoded in several calls; the result is unchanged."""
    code = load_code("576x288")
    spec = LayeredSpec(algo="OMS", iters=3, early_term=True)
    llr = llrs(code.N, 40, seed=23)
    whole = _pallas(code, spec, batch_tile=8)(llr)
    # room for 32 frames' messages per call: two calls for 40 frames
    monkeypatch.setattr(pallas_layered, "_MAX_BUF", 32 * code.M)
    split = _pallas(code, spec, batch_tile=8)(llr)
    np.testing.assert_array_equal(np.asarray(whole[0]), np.asarray(split[0]))
    assert int(whole[1]) == int(split[1])
