"""AWGN channel with BPSK/QPSK mapping, on the device.

Re-expresses the reference channels' observable behaviour with
``jax.random`` (threefry) instead of cuRAND/Box-Muller host loops:

* sigma computation from Eb/N0 or Es/N0 and code rate —
  ``code/gpu_fixed/awgn_channel/CChanel_AWGN_SIMD.cu:63-73`` /
  ``code/ldpc_decoder_arm/CChanel/CChanelAWGN_x86.cpp:67-83``:
  ``sigma = sqrt(10^(-(EbN0_dB + 10*log10(R))/10) / 2)``, with
  ``EbN0 = EsN0 - 10*log10(2R)`` in Es/N0 mode;
* BPSK maps bit 1 -> +1, bit 0 -> -1; QPSK uses +/-1/sqrt(2) per dimension
  (``CChanelAWGN_x86.cpp:99-116``);
* optional channel normalization ``2/sigma^2`` (``-norm-channel``,
  ``CChanelAWGN_x86.cpp:90-95``);
* the fused quantized path mirrors the GPU channel's
  ``clamp(8*v, +/-31) -> int8`` (``CChanel_AWGN_SIMD.cu:17-25``) via
  `quant.quantize_llr`.

Statistical (not bit-level) equivalence with the reference RNG is the
contract — the reference itself uses three different RNGs across targets.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..quant import QuantSpec, quantize_llr

__all__ = ["ChannelSpec", "sigma_for_snr", "AwgnChannel"]

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def sigma_for_snr(
    snr_db: float, rate: float, es_n0: bool = False, qpsk: bool = False
) -> float:
    """Noise sigma per real dimension from SNR in dB.

    Mirrors ``CChanel::configure`` math: in Es/N0 mode the SNR is converted
    to Eb/N0 with the 2-bits/symbol QPSK assumption used by the reference
    (``CChanelAWGN_x86.cpp:74-77``).
    """
    eb_n0 = snr_db - 10.0 * math.log10(2.0 * rate) if es_n0 else snr_db
    interm = -0.1 * (eb_n0 + 10.0 * math.log10(rate))
    return math.sqrt((10.0 ** interm) / 2.0)


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """Static channel configuration (hashable; jit static arg).

    ``fading="rayleigh"`` applies flat Rayleigh fading (unit mean-square
    gain, perfect-CSI matched filter) — the reference parses a
    ``-Rayleigh_Fading`` flag (``code/ldpc_decoder_arm/main.cpp:257``) but
    ships no implementation; here the capability is real.
    """

    qpsk: bool = False
    es_n0: bool = False
    normalize: bool = False  # -norm-channel: scale output by 2/sigma^2
    fading: str = "none"  # none | rayleigh
    opt_llr: bool = False  # -ollr: adapt quantizer scale to sigma
    no_channel: bool = False  # -no-channel: noiseless (perfect LLRs)
    # fault injection (SURVEY §5.3): probability of flipping an LLR's sign
    # after quantization — corruption beyond channel noise, for robustness
    # studies; 0 disables
    inject_flip_p: float = 0.0
    quant: QuantSpec = QuantSpec()


@partial(jax.jit, static_argnames=("spec",))
def _generate_float(key, tx_bits, sigma, spec: ChannelSpec):
    amp = _INV_SQRT2 if spec.qpsk else 1.0
    symbols = jnp.where(tx_bits != 0, amp, -amp).astype(jnp.float32)
    if spec.no_channel:
        return symbols
    k_noise, k_fade = jax.random.split(key)
    noise = sigma * jax.random.normal(k_noise, symbols.shape, jnp.float32)
    if spec.fading == "rayleigh":
        g = jax.random.normal(k_fade, (2, *symbols.shape), jnp.float32)
        h = jnp.sqrt((g[0] * g[0] + g[1] * g[1]) * 0.5)  # E[h^2] = 1
        # matched filter (perfect CSI): y = h*(h*x + n) keeps the LLR sign
        y = h * (h * symbols + noise)
    else:
        y = symbols + noise
    if spec.normalize:
        y = y * (2.0 / (sigma * sigma))
    return y


def _maybe_inject(key, q, spec: ChannelSpec):
    if spec.inject_flip_p <= 0.0:
        return q
    flip = jax.random.bernoulli(key, spec.inject_flip_p, q.shape)
    return jnp.where(flip, -q, q).astype(q.dtype)


@partial(jax.jit, static_argnames=("spec",))
def _generate_int8(key, tx_bits, sigma, factor, spec: ChannelSpec):
    k_chan, k_inj = jax.random.split(jax.random.fold_in(key, 1))
    q = quantize_llr(
        _generate_float(k_chan, tx_bits, sigma, spec), spec.quant, factor
    )
    return _maybe_inject(k_inj, q, spec)


@partial(jax.jit, static_argnames=("spec", "shape"))
def _generate_zero_int8(key, shape, sigma, factor, spec: ChannelSpec):
    """All-zero-codeword fused path (the GPU channel's only mode:
    ``CChanel_AWGN_SIMD.cu:22`` hard-codes tx = -1)."""
    zeros = jnp.zeros(shape, jnp.int8)
    k_chan, k_inj = jax.random.split(jax.random.fold_in(key, 1))
    q = quantize_llr(
        _generate_float(k_chan, zeros, sigma, spec), spec.quant, factor
    )
    return _maybe_inject(k_inj, q, spec)


class AwgnChannel:
    """AWGN channel over a [batch, N] frame block.

    ``configure(snr_db)`` fixes sigma (like ``CChanel::configure``), then
    ``generate*`` produce received LLR frames.  All device work is jitted;
    the PRNG key is threaded explicitly (functional, reproducible).
    """

    def __init__(self, n: int, k: int, spec: ChannelSpec = ChannelSpec()):
        self.n = n
        self.k = k
        self.spec = spec
        self.rate = k / n
        self.sigma: Optional[float] = None

    def configure(self, snr_db: float) -> float:
        self.sigma = sigma_for_snr(
            snr_db, self.rate, self.spec.es_n0, self.spec.qpsk
        )
        if self.spec.opt_llr:
            from ..quant import optimal_llr_factor

            self.factor = optimal_llr_factor(self.sigma, self.spec.quant)
        else:
            self.factor = float(self.spec.quant.factor)
        return self.sigma

    def generate_float(self, key, tx_bits) -> jax.Array:
        """Float received values for explicit coded bits [B, N]."""
        assert self.sigma is not None, "call configure(snr_db) first"
        return _generate_float(key, tx_bits, self.sigma, self.spec)

    def generate_int8(self, key, tx_bits) -> jax.Array:
        """Quantized int8 LLRs for explicit coded bits [B, N]."""
        assert self.sigma is not None, "call configure(snr_db) first"
        return _generate_int8(key, tx_bits, self.sigma, self.factor, self.spec)

    def generate_zero_int8(self, key, batch: int) -> jax.Array:
        """Quantized int8 LLRs for the all-zero codeword, fused RNG+quantize
        on device (the GPU channel C1 equivalent)."""
        assert self.sigma is not None, "call configure(snr_db) first"
        return _generate_zero_int8(
            key, (batch, self.n), self.sigma, self.factor, self.spec
        )
