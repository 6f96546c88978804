"""Decoder API + factory (reference L3: ``CGPUDecoder``/``CreateDecoder``).

``make_decoder`` replaces the reference's (type, arch, format) dispatch
(``code/x86/CDecoder/DecoderLibrary.h:44-137``; string-keyed ``new`` chains
in ``code/gpu_fixed/main.cpp:212-228``) with backend selection:

* ``pallas`` — the fused whole-decode GPU kernel (QC codes,
  ``kernels/pallas_layered.py``);
* ``xla``    — the gather/roll XLA path (any code, any device);
* ``auto``   — ``pallas`` for QC codes on a GPU, ``xla`` otherwise.

Staircase (DVB-S2-family) codes are transparently replaced by their Z=360
QC view (``codes.dvbs2.to_qc_form``) so they hit the QC paths; the view
handles the column permutation internally, so callers see the original
column order.

All backends share ``LayeredSpec`` and return the same
``decode(llr[B, N] int8) -> (bits[B, N] uint8, iters_used)`` contract.
"""

from __future__ import annotations

from typing import Optional

import jax

from ..codes.code import LdpcCode
from ..ops.layered import LayeredSpec, make_layered_decoder

__all__ = ["make_decoder", "LayeredSpec", "backend_for", "effective_code",
           "BACKENDS"]

BACKENDS = ("auto", "pallas", "xla")

_qc_view_cache: dict[str, Optional[LdpcCode]] = {}


def effective_code(code: LdpcCode) -> LdpcCode:
    """The code actually decoded: the QC view for staircase codes."""
    if code.Z is not None or code.col_perm is not None:
        return code
    if code.name not in _qc_view_cache:
        from ..codes.dvbs2 import is_staircase, to_qc_form

        view = None
        if is_staircase(code):
            try:
                view = to_qc_form(code)
            except ValueError:
                view = None
        _qc_view_cache[code.name] = view
    return _qc_view_cache[code.name] or code


def backend_for(code: LdpcCode, spec: LayeredSpec, backend: str = "auto") -> str:
    """Resolve ``backend``: ``auto`` takes the fused kernel for QC codes
    when JAX runs on a GPU, and the XLA path otherwise."""
    from ..kernels import pallas_supported

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend != "auto":
        return backend
    if (pallas_supported(effective_code(code), spec)
            and jax.default_backend() == "gpu"):
        return "pallas"
    return "xla"


def make_decoder(
    code: LdpcCode,
    spec: LayeredSpec = LayeredSpec(),
    backend: str = "auto",
    batch_tile: Optional[int] = None,
    interpret: bool = False,
    emit_mask: bool = False,
):
    """``emit_mask=True`` makes the decoder return a third value,
    ``ok[B] bool`` (per-frame TRUE syndrome of the output bits) — the
    phase-1 interface of two-phase ET — computed by a syndrome check fused
    into the same jitted call.  ``interpret=True`` runs the ``pallas``
    kernel in the Pallas interpreter (tests only)."""
    orig_code = code
    if spec.schedule == "flooding":
        # Flooding works on ANY code via gather/segment-sum and gains nothing
        # from the QC view, so dispatch on the ORIGINAL code: the QC view
        # carries a column permutation that make_flooding_decoder does not
        # apply, which would decode permuted H against unpermuted LLRs.
        from ..ops.flooding import make_flooding_decoder

        return _with_mask(make_flooding_decoder(code, spec), orig_code,
                          emit_mask)
    code = effective_code(code)
    resolved = backend_for(code, spec, backend)
    if resolved == "pallas":
        from ..kernels import make_pallas_decoder

        dec = make_pallas_decoder(code, spec, batch_tile=batch_tile,
                                  interpret=interpret)
    else:
        dec = make_layered_decoder(code, spec)
    return _with_mask(dec, orig_code, emit_mask)


def _with_mask(dec, code: LdpcCode, emit_mask: bool):
    """Append a fused per-frame true-syndrome check to a (bits, iters)
    decoder, yielding the emit_mask contract ``(bits, iters, ok[B])`` in
    ONE jitted dispatch."""
    if not emit_mask:
        return dec
    from .twophase import syndrome_fn

    ok_fn = syndrome_fn(code)

    @jax.jit
    def dec_mask(llr):
        bits, iters = dec(llr)
        return bits, iters, ok_fn(bits)

    return dec_mask
