"""Two-phase (compaction) early termination over a whole batch.

The reference's EARLY_TERM breaks per CUDA thread (4 packed codewords,
``CUDA_2NMS_SIMD.cu:17``, break at ``CUDA_MS_SIMD.cu:242-245``): threads
that finish retire and free SM issue slots.  A batched decoder that
iterates a whole batch (the XLA path's ``while_loop``) runs until the
slowest codeword converges.  Two-phase ET exploits the batch instead:

* phase 1 decodes the whole batch at a fixed ``k1`` iterations with the
  decoder's ``emit_mask`` output: a syndrome check fused into the same
  jitted call gives each frame's TRUE-syndrome bit — there is NO separate
  syndrome stage;
* the host fetches ONE scalar per batch — the unconverged-frame count —
  to pick the phase-2 bucket executable; the gather/scatter compaction
  itself runs entirely ON DEVICE (argsort of the convergence mask), so
  no index arrays ever cross the host boundary;
* phase 2 re-decodes only the unconverged frames at the full iteration
  budget, at a power-of-two bucketed batch shape (one cached executable
  per bucket, so no compilation lands inside a timed region).

Output semantics, precisely: frames whose ``k1``-depth hard decisions
already satisfy every parity check return those bits — a valid codeword,
exactly a per-frame EARLY_TERM exit (decoding is deterministic, and the
in-kernel ET freeze likewise stops them there when ``k1`` ≥ their
convergence point).  Frames still
unconverged at ``k1`` are re-decoded at the full fixed budget; that
matches a per-frame-ET decoder whenever the hard decisions are stable
between the frame's first convergence and the budget — the typical case,
but NOT a structural guarantee (layered min-sum keeps updating APP after
the syndrome clears, and a post-convergence flip would make the two
differ; such a frame would usually re-enter the unconverged set anyway).
The expensive deep decode runs on the few-percent tail instead of the
whole batch: effective cost per frame approaches ``k1 + FER(k1) * iters``
instead of ``max_frame(iters_used)``.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.code import LdpcCode
from ..ops.layered import LayeredSpec

__all__ = ["make_twophase_decoder", "onehot_gather", "syndrome_fn"]


def syndrome_fn(code: LdpcCode):
    """Jittable per-frame syndrome check: ``ok[B] = all checks satisfied``.

    Works on the ORIGINAL code's edge table (hard bits are in original
    column order at the decoder boundary)."""
    tables = [jnp.asarray(ci) for ci in code.class_idx]

    def ok(bits: jax.Array):  # [B, N] uint8
        good = None
        for ci in tables:
            par = bits[:, ci.reshape(-1)].reshape(
                bits.shape[0], ci.shape[0], ci.shape[1]
            )
            unsat = jnp.any(par.sum(axis=2) & 1, axis=1)
            good = ~unsat if good is None else (good & ~unsat)
        return good

    return ok


def onehot_gather(llr: jax.Array, idx: jax.Array) -> jax.Array:
    """Rows ``idx`` of ``llr[B, N] int8`` as a one-hot bf16 matrix product.

    Exact: every output element is one product of 1.0 and an int8 value,
    which bf16 holds exactly, summed in float32.  Indices outside ``[0, B)``
    give a zero row.  Equal to ``jnp.take(llr, idx, axis=0)`` for in-range
    indices (pinned by tests)."""
    oh = (idx[:, None] == jnp.arange(llr.shape[0], dtype=idx.dtype)[None, :]
          ).astype(jnp.bfloat16)
    return jnp.dot(oh, llr.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32).astype(jnp.int8)


def make_twophase_decoder(
    code: LdpcCode,
    spec: LayeredSpec,
    k1: int = 5,
    backend: str = "auto",
    tail_pad: int = 128,
    interpret: bool = False,
):
    """Build ``decode(llr[B, N]) -> (bits[B, N] uint8, stats dict)``.

    ``spec.iters`` is the full budget; ``spec.early_term`` is implied (the
    phase structure IS the early termination).  ``stats`` reports phase-2
    frame count and the effective decoded-iterations per frame.
    """
    import dataclasses

    from . import make_decoder

    base = dataclasses.replace(spec, early_term=False)
    dec1 = make_decoder(
        code, dataclasses.replace(base, iters=k1), backend=backend,
        interpret=interpret, emit_mask=True,
    )
    dec2 = make_decoder(code, base, backend=backend, interpret=interpret)

    @jax.jit
    def phase1(llr):
        """One dispatch: k1-iteration decode + in-kernel/fused convergence
        mask + the unconverged count (the ONLY value the host ever reads)."""
        bits, _, ok = dec1(llr)
        return bits, ok, jnp.sum(~ok)

    _p2: dict[int, object] = {}

    def _gather_idx(ok, t: int):
        """Indices of the first ``t`` unconverged frames (original order;
        out-of-range ``b`` fill beyond the count): a 2-D-reshaped cumsum
        plus searchsorted, or a stable argsort for small batches."""
        b = ok.shape[0]
        if b >= 128 and b % 128 == 0:
            cdim = 128
            bad2 = (~ok).reshape(b // cdim, cdim).astype(jnp.int32)
            incl = jnp.cumsum(bad2, axis=1)  # lane-axis scan: fast
            row = incl[:, -1]
            row_off = jnp.cumsum(row) - row
            c = (row_off[:, None] + incl).reshape(-1)  # inclusive prefix
            return jnp.searchsorted(
                c, jnp.arange(1, t + 1, dtype=jnp.int32)
            ).astype(jnp.int32)
        idx = jnp.argsort(ok.astype(jnp.int32), stable=True)
        return idx[:t]

    def _phase2_for(t: int):
        """Phase-2 executable at bucket size ``t``: on-device compaction,
        deep decode of the bucketed tail, scatter-merge.  No host index
        building, no host->device uploads.  The tail-LLR gather is a
        one-hot bf16 matrix product (``onehot_gather``), exact for int8
        LLRs."""
        if t not in _p2:

            @jax.jit
            def p2(llr, bits, ok):
                b = llr.shape[0]
                te = min(t, b)  # bucket may round past a small batch
                gat = _gather_idx(ok, te)  # tail + fill (fill rows decode
                # zeros / duplicates and are discarded by the scatter)
                tail_llr = onehot_gather(llr, gat)
                tail_bits, _ = dec2(tail_llr)
                cnt = jnp.sum(~ok)
                # scatter only the true tail; fill rows target the
                # out-of-range index b -> dropped by XLA scatter mode="drop"
                scat = jnp.where(jnp.arange(te) < cnt, gat, b)
                return bits.at[scat].set(tail_bits, mode="drop")

            _p2[t] = p2
        return _p2[t]

    def _bucket(n: int, b: int) -> int:
        """Tail batch size: the next power-of-two multiple of ``tail_pad``
        (capped at the padded full batch).  A raw ``pad-to-128`` would give
        a different phase-2 shape on almost every call, and dec2 (a jitted
        decoder) retraces and recompiles per new shape.  Buckets bound the
        distinct shapes to log2(b/tail_pad)+1."""
        cap = -(-b // tail_pad) * tail_pad
        t = tail_pad
        while t < n:
            t *= 2
        return min(t, cap)

    def _stats(n_bad: int, tail: int, b: int) -> dict:
        return {
            "phase2_frames": int(n_bad),
            # what the DEVICE decodes: phase 2 runs the BUCKETED tail
            # (power-of-two multiple of tail_pad), not n_bad frames —
            # the honest cost stat charges the bucketed batch
            "phase2_batch": int(tail),
            "eff_iters_per_frame": k1 + spec.iters * tail / max(b, 1),
            # the unbucketed ideal (what a perfectly-shaped phase 2 would
            # cost), kept for comparing against the k1 + FER(k1)*budget model
            "eff_iters_per_frame_ideal":
                k1 + spec.iters * n_bad / max(b, 1),
        }

    def decode(llr, ref_bits: Optional[np.ndarray] = None):
        del ref_bits
        llr = jnp.asarray(llr, jnp.int8)  # stays on device throughout
        b = llr.shape[0]
        bits, ok, cnt = phase1(llr)
        n_bad = int(cnt)  # the one host fetch: a single scalar
        tail = _bucket(n_bad, b) if n_bad else 0
        stats = _stats(n_bad, tail, b)
        if n_bad == 0:
            return bits, stats
        out = _phase2_for(tail)(llr, bits, ok)
        return out, stats

    def warm_buckets(llr) -> list[int]:
        """Compile phase 1 and EVERY possible phase-2 bucket executable
        for this batch shape (dummy mask; results discarded).  Call
        before timing: otherwise the first occurrence of each tail bucket
        puts a compilation inside the timed region."""
        llr = jnp.asarray(llr, jnp.int8)
        b = llr.shape[0]
        bits, ok, _ = phase1(llr)
        cap = -(-b // tail_pad) * tail_pad
        sizes = []
        t = tail_pad
        while t < cap:
            sizes.append(t)
            t *= 2
        sizes.append(cap)
        for t in sizes:
            jax.block_until_ready(_phase2_for(t)(llr, bits, ok))
        return sizes

    def decode_pipelined(llrs):
        """Decode a SEQUENCE of batches with software pipelining: every
        batch's phase 1 is dispatched up front (the device queue holds
        them), and the per-batch unconverged COUNTS — one int32 each, the
        only host-visible values in the whole design — are fetched in a
        single stacked transfer, once per window, not once per batch.
        Phase 2 then dispatches per batch with its on-device compaction;
        no other host<->device traffic exists.  This is how a production
        sweep consumes the decoder (`sim/sweep.py`'s dispatch window does
        the same for whole sim steps).

        Returns (list of bits arrays, aggregate stats dict)."""
        staged = [phase1(jnp.asarray(x, jnp.int8)) for x in llrs]
        cnts = np.asarray(jnp.stack([c for _, _, c in staged]))
        outs = []
        agg = {"phase2_frames": 0, "phase2_batch": 0, "frames": 0}
        for x, (bits, ok, _), n_bad in zip(llrs, staged, cnts):
            b = int(np.shape(x)[0])
            n_bad = int(n_bad)
            tail = _bucket(n_bad, b) if n_bad else 0
            agg["phase2_frames"] += n_bad
            agg["phase2_batch"] += int(tail)
            agg["frames"] += b
            if n_bad == 0:
                outs.append(bits)
                continue
            outs.append(
                _phase2_for(tail)(jnp.asarray(x, jnp.int8), bits, ok)
            )
        agg["eff_iters_per_frame"] = (
            k1 + spec.iters * agg["phase2_batch"] / max(agg["frames"], 1)
        )
        return outs, agg

    # ---- fused single-dispatch variant -------------------------------
    # Phase 1 + compaction + phase 2 + merge as ONE jitted executable
    # with a FIXED tail bucket ``t``: zero extra dispatches per batch
    # (each separate launch carries host scheduling that the small codes
    # cannot amortize).  The fixed
    # bucket can overflow (cnt > t) — the per-window count fetch catches
    # that and the rare overflowing batch is re-decoded at the full
    # budget (exact, just slower for that batch).

    _fused: dict[int, object] = {}

    def _fused_for(t: int, b: int):
        te = min(t, b)
        if te not in _fused:

            @jax.jit
            def fstep(llr):
                bits, _, ok = dec1(llr)
                gat = _gather_idx(ok, te)
                tail_llr = onehot_gather(llr, gat)
                tail_bits, _ = dec2(tail_llr)
                cnt = jnp.sum(~ok)
                scat = jnp.where(jnp.arange(te) < cnt, gat, b)
                out = bits.at[scat].set(tail_bits, mode="drop")
                return out, cnt

            _fused[te] = fstep
        return _fused[te]

    def decode_pipelined_fused(llrs, tail: int = None):
        """Like ``decode_pipelined`` but one executable per batch (fixed
        tail bucket, default ``tail_pad``).  Batches whose unconverged
        count overflows the bucket are re-decoded at the full budget
        after the window's count fetch.  Returns (outs, agg stats)."""
        t = tail if tail is not None else tail_pad
        staged = []
        for x in llrs:
            xd = jnp.asarray(x, jnp.int8)
            staged.append(_fused_for(t, xd.shape[0])(xd))
        cnts = np.asarray(jnp.stack([c for _, c in staged]))
        outs = []
        agg = {"phase2_frames": 0, "phase2_batch": 0, "frames": 0,
               "overflows": 0}
        extra_full = 0
        for x, (out, _), n_bad in zip(llrs, staged, cnts):
            b = int(np.shape(x)[0])
            te = min(t, b)
            n_bad = int(n_bad)
            agg["phase2_frames"] += n_bad
            agg["phase2_batch"] += te
            agg["frames"] += b
            if n_bad > te:  # bucket overflow: exact repair, full budget
                agg["overflows"] += 1
                extra_full += b
                outs.append(dec2(jnp.asarray(x, jnp.int8))[0])
            else:
                outs.append(out)
        agg["eff_iters_per_frame"] = (
            k1
            + spec.iters
            * (agg["phase2_batch"] + extra_full)
            / max(agg["frames"], 1)
        )
        return outs, agg

    def warm_fused(llr, tail: int = None) -> None:
        llr = jnp.asarray(llr, jnp.int8)
        t = tail if tail is not None else tail_pad
        jax.block_until_ready(_fused_for(t, llr.shape[0])(llr)[0])

    decode.warm_buckets = warm_buckets
    decode.pipelined = decode_pipelined
    decode.pipelined_fused = decode_pipelined_fused
    decode.warm_fused = warm_fused
    return decode
