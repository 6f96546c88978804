"""Channel, quantization, and encoder tests.

Statistical contracts mirror the reference channels (sigma math of
``CChanel::configure``, quantizer of ``CFastFixConversion``/
``CChanel_AWGN_SIMD``); encoder outputs must satisfy every parity check of
their code (the property the reference never tests but relies on).
"""

import math

import jax
import numpy as np
import pytest

from ldpcgputegra.channel import (
    AwgnChannel,
    ChannelSpec,
    FakeEncoder,
    GF2Encoder,
    QCAccumulateEncoder,
    StaircaseEncoder,
    make_encoder,
    generate_info_bits,
    sigma_for_snr,
)
from ldpcgputegra.codes.registry import load_code
from ldpcgputegra.golden.decoder import syndrome_ok
from ldpcgputegra.quant import QuantSpec, quantize_llr


def test_sigma_formula():
    # sigma = sqrt(1 / (2 R 10^(EbN0/10)))  (CChanel_AWGN_SIMD.cu:63-73)
    for snr, rate in [(0.0, 0.5), (2.5, 0.5), (4.0, 13 / 16)]:
        expect = math.sqrt(1.0 / (2 * rate * 10 ** (snr / 10.0)))
        assert sigma_for_snr(snr, rate) == pytest.approx(expect, rel=1e-12)
    # Es/N0 mode: EbN0 = EsN0 - 10 log10(2R)
    assert sigma_for_snr(3.0, 0.5, es_n0=True) == pytest.approx(
        sigma_for_snr(3.0 - 10 * math.log10(1.0), 0.5), rel=1e-12
    )


def test_quantize_trunc_toward_zero():
    spec = QuantSpec(factor=8, bits_llr=6)
    x = np.array([-5.0, -0.99, -0.1, 0.0, 0.1, 0.99, 5.0], np.float32)
    q = np.asarray(quantize_llr(x, spec))
    # C semantics: int(8*x) truncates toward zero, clamp +/-31
    expect = np.clip(np.trunc(8.0 * x), -31, 31).astype(np.int8)
    np.testing.assert_array_equal(q, expect)
    assert spec.sat == 31


def test_channel_noise_statistics():
    chan = AwgnChannel(4000, 2000)
    sigma = chan.configure(2.0)
    key = jax.random.key(0)
    tx = np.zeros((64, 4000), np.int8)
    y = np.asarray(chan.generate_float(key, tx))
    # bit 0 -> -1 BPSK symbol plus N(0, sigma^2)
    assert y.mean() == pytest.approx(-1.0, abs=0.01)
    assert y.std() == pytest.approx(sigma, rel=0.02)


def test_channel_zero_path_matches_explicit_bits():
    chan = AwgnChannel(576, 288)
    chan.configure(1.0)
    key = jax.random.key(7)
    tx = np.zeros((8, 576), np.int8)
    a = np.asarray(chan.generate_int8(key, tx))
    b = np.asarray(chan.generate_zero_int8(key, 8))
    np.testing.assert_array_equal(a, b)
    assert a.min() >= -31 and a.max() <= 31


def test_uncoded_ber_matches_theory():
    """Hard decisions on raw channel output ~= Q(sqrt(2 R EbN0)) — validates
    the sigma computation end-to-end, the statistical oracle of SURVEY §4."""
    n, k = 4000, 2000
    chan = AwgnChannel(n, k)
    chan.configure(2.0)
    tx = np.zeros((256, n), np.int8)
    y = np.asarray(chan.generate_float(jax.random.key(3), tx))
    ber = (y > 0).mean()
    snr_lin = 10 ** (2.0 / 10.0)
    q = 0.5 * math.erfc(math.sqrt(2 * 0.5 * snr_lin) / math.sqrt(2.0))
    assert ber == pytest.approx(q, rel=0.05)


def test_fake_encoder():
    enc = FakeEncoder(576, 288)
    out = enc.encode(np.ones((3, 288), np.int8))
    assert out.shape == (3, 576) and out.sum() == 0


@pytest.mark.parametrize("name", ["576x288", "1944x972"])
def test_gf2_encoder_satisfies_syndrome(name):
    code = load_code(name)
    enc = GF2Encoder(code)
    rng = np.random.default_rng(5)
    info = generate_info_bits(rng, 4, code.K)
    coded = enc.encode(info)
    np.testing.assert_array_equal(coded[:, : code.K], info)
    for b in range(4):
        assert syndrome_ok(code, coded[b])


def test_staircase_encoder_dvbs2():
    code = load_code("16200x7560")
    enc = StaircaseEncoder(code)
    rng = np.random.default_rng(9)
    info = generate_info_bits(rng, 2, code.K)
    coded = enc.encode(info)
    for b in range(2):
        assert syndrome_ok(code, coded[b])


def test_qc_accumulate_encoder_table():
    """The imported DVB table (N=16200, K=10800) must produce self-consistent
    staircase parities: re-encoding the same info is deterministic and
    parity obeys the accumulate recurrence."""
    import os

    path = os.path.join(
        os.path.dirname(__file__),
        "..",
        "ldpcgputegra",
        "codes",
        "data",
        "encoder_16200x10800.json",
    )
    enc = QCAccumulateEncoder.from_json(path)
    rng = np.random.default_rng(11)
    info = generate_info_bits(rng, 2, enc.k)
    c1 = enc.encode(info)
    c2 = enc.encode(info)
    np.testing.assert_array_equal(c1, c2)
    assert c1.shape == (2, 16200)
    assert set(np.unique(c1)).issubset({0, 1})
    # all-zero info -> all-zero codeword (linear code)
    z = enc.encode(np.zeros((1, enc.k), np.int8))
    assert z.sum() == 0


def test_make_encoder_auto():
    code = load_code("576x288")
    enc = make_encoder(code, "auto")
    info = generate_info_bits(np.random.default_rng(1), 2, code.K)
    coded = enc.encode(info)
    if not isinstance(enc, FakeEncoder):
        for b in range(2):
            assert syndrome_ok(code, coded[b])


def test_rayleigh_fading_statistics():
    """Matched-filter Rayleigh output: E[y] = E[h^2]*(-1) = -1 for bit 0,
    and BER is much worse than AWGN at the same SNR (fading penalty)."""
    from ldpcgputegra.channel import AwgnChannel, ChannelSpec

    n = 4000
    tx = np.zeros((128, n), np.int8)
    ray = AwgnChannel(n, 2000, ChannelSpec(fading="rayleigh"))
    awgn = AwgnChannel(n, 2000, ChannelSpec())
    ray.configure(6.0)
    awgn.configure(6.0)
    yr = np.asarray(ray.generate_float(jax.random.key(1), tx))
    ya = np.asarray(awgn.generate_float(jax.random.key(1), tx))
    assert yr.mean() == pytest.approx(-1.0, abs=0.02)
    ber_ray = (yr > 0).mean()
    ber_awgn = (ya > 0).mean()
    assert ber_ray > 3 * ber_awgn


def test_llr_histogram():
    from ldpcgputegra.quant import QuantSpec, llr_histogram

    q = np.array([-31, -31, 0, 5, 31], np.int8)
    h = llr_histogram(q, QuantSpec())
    assert h[-31] == pytest.approx(40.0)
    assert h[31] == pytest.approx(20.0)
    assert sum(h.values()) == pytest.approx(100.0)


def test_optimal_llr_factor():
    from ldpcgputegra.quant import QuantSpec, optimal_llr_factor

    spec = QuantSpec()
    f_low = optimal_llr_factor(0.5, spec)   # low noise -> larger scale
    f_high = optimal_llr_factor(1.5, spec)  # high noise -> smaller scale
    assert f_low > f_high > 0
    # adaptive channel still saturates within range and decodes
    chan = AwgnChannel(576, 288, ChannelSpec(opt_llr=True))
    chan.configure(2.0)
    q = np.asarray(chan.generate_zero_int8(jax.random.key(0), 16))
    assert q.min() >= -31 and q.max() <= 31
    assert (np.abs(q) > 20).mean() > 0.01  # uses the upper range


def test_qpsk_and_esn0_modes():
    """QPSK halves per-dimension amplitude; Es/N0 mode shifts sigma by
    10*log10(2R) (CChanel::configure semantics)."""
    n, k = 4000, 2000
    tx = np.zeros((64, n), np.int8)
    q = AwgnChannel(n, k, ChannelSpec(qpsk=True))
    q.configure(6.0)
    y = np.asarray(q.generate_float(jax.random.key(2), tx))
    assert y.mean() == pytest.approx(-1 / math.sqrt(2), abs=0.01)
    # Es/N0 3.0 == Eb/N0 3.0 - 10log10(2*0.5) = 3.0 for rate 1/2
    a = AwgnChannel(n, k, ChannelSpec(es_n0=True))
    b = AwgnChannel(n, k, ChannelSpec())
    assert a.configure(3.0) == pytest.approx(b.configure(3.0))
    # rate 13/16: Es/N0 differs from Eb/N0
    c = AwgnChannel(2048, 1664, ChannelSpec(es_n0=True))
    d = AwgnChannel(2048, 1664, ChannelSpec())
    assert c.configure(3.0) != pytest.approx(d.configure(3.0))


def test_make_qc_code_roundtrip():
    from ldpcgputegra.codes.registry import make_qc_code

    base = np.array([[0, 1, -1, 2, 0, -1],
                     [-1, 0, 3, -1, 1, 0]])
    code = make_qc_code("toy", base, Z=8)
    assert code.N == 48 and code.K == 32 and code.Z == 8
    assert code.is_qc and len(code.layers) == 2
    code.check_valid()


def test_no_channel_and_fault_injection():
    n, k = 576, 288
    chan = AwgnChannel(n, k, ChannelSpec(no_channel=True))
    chan.configure(1.0)
    q = np.asarray(chan.generate_zero_int8(jax.random.key(0), 4))
    assert (q == -8).all()  # perfect -1 symbols x factor 8, no noise
    inj = AwgnChannel(
        n, k, ChannelSpec(no_channel=True, inject_flip_p=0.25)
    )
    inj.configure(1.0)
    qi = np.asarray(inj.generate_zero_int8(jax.random.key(0), 64))
    flipped = (qi == 8).mean()
    assert 0.2 < flipped < 0.3  # ~25% of signs flipped


def test_gf2_encoder_high_rate_code():
    """10GBASE-T-like 2048x384 (rate 13/16): dense GF(2) encoder works."""
    code = load_code("2048x384")
    assert code.K == 2048 - 384
    enc = GF2Encoder(code)
    info = generate_info_bits(np.random.default_rng(7), 2, code.K)
    coded = enc.encode(info)
    for b in range(2):
        assert syndrome_ok(code, coded[b])
