"""Decoder extras: test-double and heterogeneous-split decoders.

* `make_fake_decoder` — hard-decision passthrough, no message passing; the
  harness test double (reference D14, ``CFakeDecoder.h:24-33``).
* `make_hybrid_decoder` — splits each batch between the device decoder and
  the host-side native C++ oracle, the analogue of the reference's
  heterogeneous ARM+GPU operation where the NEON decoder embeds a GPU
  decoder and routes a slice of the frames to it
  (``CDecoder_OMS_fixed_NEON16_v2.cpp:106-116,288-327``).  On a GPU host
  the practical split is 0 (device does everything); the capability exists
  for parity and for host-burst absorb during device contention.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.code import LdpcCode
from ..ops.layered import LayeredSpec
from . import make_decoder

__all__ = ["make_fake_decoder", "make_hybrid_decoder"]


def make_fake_decoder(code: LdpcCode):
    """Hard-decision passthrough: bits = (llr > 0); iters_used = 0."""

    @jax.jit
    def decode(llr):
        return (jnp.asarray(llr) > 0).astype(jnp.uint8), jnp.asarray(
            0, jnp.int32
        )

    return decode


def make_hybrid_decoder(
    code: LdpcCode,
    spec: LayeredSpec = LayeredSpec(),
    host_fraction: float = 0.25,
    backend: str = "auto",
):
    """Decode ``host_fraction`` of each batch on the host C++ oracle and
    the rest on the device decoder, concurrently (device dispatch is
    async, so the host slice overlaps device compute)."""
    from ..golden import GoldenParams, decode_oracle
    from ..golden.native import native_available

    assert native_available(), "hybrid decoder needs the native oracle"
    dev = make_decoder(code, spec, backend=backend)
    gp = GoldenParams(
        algo=spec.algo,
        iters=spec.iters,
        offset=spec.offset,
        early_term=spec.early_term,
        minclamp=spec.minclamp,
    )

    def decode(llr):
        llr = np.asarray(llr)
        b = llr.shape[0]
        nh = int(b * host_fraction)
        # round the device slice to a lane multiple when possible
        nd = b - nh
        if nd % 128 and b - (nd - nd % 128) <= b:
            nd -= nd % 128
            nh = b - nd
        dev_out = dev(llr[:nd]) if nd else None  # async dispatch
        if nh:
            host_bits, host_used = decode_oracle(code, llr[nd:], gp)
        bits = np.empty((b, code.N), np.uint8)
        # iters_used covers the WHOLE batch: max of the device slice's
        # scalar count and the host slice's per-frame counts
        used = 0
        if dev_out is not None:
            bits[:nd] = np.asarray(dev_out[0])
            used = int(dev_out[1])
        if nh:
            bits[nd:] = host_bits.astype(np.uint8)
            used = max(used, int(np.max(host_used)))
        return bits, used

    return decode
