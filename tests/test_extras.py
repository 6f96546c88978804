"""Fake decoder, hybrid decoder, and debug utilities."""

import numpy as np
import pytest

from ldpcgputegra.codes.registry import load_code
from ldpcgputegra.decoder.extras import make_fake_decoder, make_hybrid_decoder
from ldpcgputegra.golden.native import native_available
from ldpcgputegra.ops.layered import LayeredSpec, make_layered_decoder
from ldpcgputegra.utils.debug import check_dataset


def _llrs(n, b, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(
        8.0 * rng.normal(-1.0, 0.8, size=(b, n)), -31, 31
    ).astype(np.int8)


def test_fake_decoder_passthrough():
    code = load_code("576x288")
    dec = make_fake_decoder(code)
    llr = _llrs(code.N, 4)
    bits, used = dec(llr)
    np.testing.assert_array_equal(np.asarray(bits), (llr > 0).astype(np.uint8))
    assert int(used) == 0


@pytest.mark.skipif(not native_available(), reason="native oracle not built")
def test_hybrid_decoder_matches_pure_device():
    code = load_code("576x288")
    spec = LayeredSpec(algo="OMS", iters=5)
    hybrid = make_hybrid_decoder(code, spec, host_fraction=0.5, backend="xla")
    pure = make_layered_decoder(code, spec)
    llr = _llrs(code.N, 256, seed=3)
    hb, _ = hybrid(llr)
    pb, _ = pure(llr)
    np.testing.assert_array_equal(hb, np.asarray(pb))


def test_check_dataset(capsys):
    a = np.arange(10)
    assert check_dataset("same", a, a.copy())
    b = a.copy()
    b[3] = 99
    assert not check_dataset("diff", a, b)
    out = capsys.readouterr().out
    assert "OK" in out and "differ" in out


def test_decode_stream_ordered_results():
    from ldpcgputegra.decoder.stream import DecodeStream
    from ldpcgputegra.golden import GoldenParams, decode_oracle

    code = load_code("576x288")
    spec = LayeredSpec(algo="OMS", iters=4)
    stream = DecodeStream(code, spec, backend="xla", depth=2)
    batches = [_llrs(code.N, 8, seed=s) for s in range(5)]
    for b in batches:
        stream.submit(b)
    assert stream.pending == 5
    outs = list(stream.drain())
    assert len(outs) == 5 and stream.pending == 0
    gp = GoldenParams(algo="OMS", iters=4)
    for (bits, _), llr in zip(outs, batches):
        refs, _ = decode_oracle(code, llr, gp)
        np.testing.assert_array_equal(bits, refs)


def test_twophase_decoder_matches_per_frame_early_term():
    """Two-phase compaction ET == per-frame ET semantics: frames converged
    at k1 keep their k1-iteration bits; the rest get full-depth bits."""
    import numpy as np

    from ldpcgputegra.codes.registry import load_code
    from ldpcgputegra.decoder.twophase import (
        make_twophase_decoder,
        syndrome_fn,
    )
    from ldpcgputegra.ops.layered import LayeredSpec, make_layered_decoder

    code = load_code("576x288")
    spec = LayeredSpec(algo="OMS", iters=10)
    rng = np.random.default_rng(17)
    # noisy enough that some frames need more than k1=3 iterations
    llr = np.clip(
        8.0 * (-1.0 + 0.75 * rng.normal(size=(64, code.N))), -31, 31
    ).astype(np.int8)
    tp = make_twophase_decoder(code, spec, k1=3, backend="xla")
    bits, stats = tp(llr)
    d1 = make_layered_decoder(code, LayeredSpec(algo="OMS", iters=3))
    d10 = make_layered_decoder(code, spec)
    bits3 = np.asarray(d1(llr)[0])
    bits10 = np.asarray(d10(llr)[0])
    ok3 = np.asarray(syndrome_fn(code)(bits3))
    assert stats["phase2_frames"] == int((~ok3).sum())
    assert 0 < stats["phase2_frames"] < 64  # the test is non-trivial
    np.testing.assert_array_equal(bits[ok3], bits3[ok3])
    np.testing.assert_array_equal(bits[~ok3], bits10[~ok3])


def test_twophase_pipelined_matches_serial():
    """decode_pipelined returns exactly the per-batch serial results (the
    pipelining only reorders dispatch, never computation)."""
    from ldpcgputegra.decoder.twophase import make_twophase_decoder

    code = load_code("576x288")
    spec = LayeredSpec(algo="OMS", iters=8)
    tp = make_twophase_decoder(code, spec, k1=4)
    rng = np.random.default_rng(5)
    llrs = [
        np.clip(8.0 * rng.normal(-1.0, 0.8, size=(256, code.N)), -31, 31)
        .astype(np.int8)
        for _ in range(3)
    ]
    serial = [np.asarray(tp(x)[0]) for x in llrs]
    piped, agg = tp.pipelined(llrs)
    for a, b in zip(serial, piped):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert agg["frames"] == 3 * 256


def test_twophase_pipelined_fused_matches_serial():
    """The fused single-dispatch variant returns the same bits as the
    serial two-phase decoder, including when the fixed tail bucket
    overflows (exact repair via full-budget re-decode)."""
    from ldpcgputegra.decoder.twophase import make_twophase_decoder

    code = load_code("576x288")
    spec = LayeredSpec(algo="OMS", iters=8)
    tp = make_twophase_decoder(code, spec, k1=4)
    rng = np.random.default_rng(11)
    llrs = [
        np.clip(8.0 * rng.normal(-1.0, 0.8, size=(256, code.N)), -31, 31)
        .astype(np.int8)
        for _ in range(3)
    ]
    serial = [np.asarray(tp(x)[0]) for x in llrs]
    # tail=128 with sigma-0.8 noise: most 256-frame batches carry >128
    # unconverged frames at k1=4 -> exercises the overflow repair path
    piped, agg = tp.pipelined_fused(llrs, tail=128)
    for a, b in zip(serial, piped):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert agg["frames"] == 3 * 256
    assert agg["overflows"] > 0, "test must exercise the overflow repair"
    # big tail (no overflow) must agree too
    piped2, agg2 = tp.pipelined_fused(llrs, tail=256)
    assert agg2["overflows"] == 0
    for a, b in zip(serial, piped2):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("b,t", [(16, 5), (130, 128), (64, 1)])
def test_onehot_gather_equals_take(b, t):
    """The two-phase tail gather (one-hot bf16 product, float32 sum) is
    exact for int8 LLRs: it equals ``jnp.take`` row for row, over the whole
    int8 range."""
    import jax.numpy as jnp

    from ldpcgputegra.decoder.twophase import onehot_gather

    rng = np.random.default_rng(b + t)
    llr = jnp.asarray(rng.integers(-128, 128, size=(b, 97)), jnp.int8)
    idx = jnp.asarray(rng.integers(0, b, size=t), jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(onehot_gather(llr, idx)),
        np.asarray(jnp.take(llr, idx, axis=0)),
    )
