"""Fused layered min-sum decoder as one Pallas-Triton GPU kernel (QC codes).

The whole decode — every iteration, every layer — runs inside one kernel,
in the layout of the reference's CUDA decoders
(``code/gpu_fixed/decoder_ms/cuda/CUDA_MS_SIMD.cu:25-248``):

* one program (thread block) per tile of ``TB`` codewords; codewords are the
  contiguous axis of the node-major APP array ``[N, B]`` and of the message
  array, so every load and store of a row of the tile coalesces — the
  reference's interleaved int8x4 codeword packing;
* the APP array lives in device memory (the kernel decodes in place in the
  transposed LLR buffer) and the c2v messages are int8 in device memory;
  nothing leaves the kernel between layers or iterations, so XLA's per-layer
  fusions and their writebacks of whole block-columns disappear;
* a layer (QC block-row) is processed in chunks of ``R`` check rows; the
  edge at position j of check z reads VN ``col_j*Z + (z + shift_j) % Z``
  through an integer row-index vector (masked past Z), so no roll is ever
  materialised;
* layers and iterations are loops inside the program, driven by small
  per-layer tables (block-columns, shifts, degree, message offset and a
  per-row flag word for sub-pass commits and deficient circulants), so the
  compiled program does not grow with the code; a block barrier separates
  layers, because the next layer reads APP rows other threads wrote;
* early termination is per codeword, as the reference's per-thread
  EARLY_TERM break (``CUDA_2NMS_SIMD.cu:17``): a converged codeword's loads
  and stores are masked off, and a tile stops iterating once all of its
  codewords have converged.

Bit-exact with ``ops.layered`` (same integer arithmetic, same schedule): the
checks of one layer touch pairwise-disjoint VNs, so a layer's rows may be
processed in any order, and uncommitted sub-pass rows and deficient-circulant
edges are simply never loaded or stored.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..codes.code import LdpcCode
from ..ops.layered import LayeredSpec, _cn_update

__all__ = ["make_pallas_decoder", "pallas_supported", "pick_rows",
           "pick_batch_tile", "pick_num_warps"]

_COMMIT = 1  # flag bit: this check row commits its updates
_MASKED = 2  # flag bit: this row's ``mask_edge`` edge is absent from H
# Largest message or APP buffer one call may address: Pallas-Triton uses
# 32-bit element offsets for buffers below 4 GiB, so stay in signed range.
_MAX_BUF = (1 << 31) - 1


def pallas_supported(code: LdpcCode, spec: LayeredSpec) -> bool:
    """True when every layer of the reference schedule is a QC block-row."""
    if spec.schedule not in ("auto", "reference"):
        return False
    return code.Z is not None and all(l.qc is not None for l in code.layers)


def pick_rows(Z: int) -> int:
    """Check rows per chunk: the largest power of two up to 128 whose
    padding of Z stays within 20% (more rows per chunk = more threads per
    program; padded rows cost ALU work, never memory traffic)."""
    r = 128
    while r > 8 and -(-Z // r) * r > 1.2 * Z:
        r //= 2
    return r


def pick_batch_tile(B: int, rows: int) -> int:
    """Codewords per program: the widest power of two up to 64 that keeps
    the tile at most 2048 elements and the grid at 32 programs or more
    (tuned on an H100 at 2304x1152, 64800x32400-dvbs2 and 64800x21600)."""
    tb = 64
    while tb > 8 and (rows * tb > 2048 or B // tb < 32):
        tb //= 2
    return tb


def pick_num_warps(rows: int, tb: int) -> int:
    """Warps per program: one per 128 tile elements, between 4 and 8."""
    return min(8, max(4, rows * tb // 128))


def _tables(code: LdpcCode, R: int):
    layers = code.layers
    L = len(layers)
    D = max(l.deg for l in layers)
    Z = code.Z
    NC = -(-Z // R)
    cols = np.zeros((L, D), np.int32)
    shifts = np.zeros((L, D), np.int32)
    degs = np.zeros(L, np.int32)
    mes = np.full(L, -1, np.int32)
    moffs = np.zeros(L, np.int32)
    flags = np.zeros((L, NC * R), np.int32)
    off = 0
    for i, l in enumerate(layers):
        q = l.qc
        cols[i, : l.deg] = q.cols
        shifts[i, : l.deg] = q.shifts
        degs[i] = l.deg
        moffs[i] = off
        off += l.deg
        rows = np.arange(Z) if q.commit_rows is None else q.commit_rows
        flags[i, rows] = _COMMIT
        if q.mask_edge is not None:
            mes[i] = q.mask_edge
            flags[i, q.mask_rows] |= _MASKED
    return (cols, shifts, degs, mes, moffs, flags), D, NC, off


def _build_kernel(code: LdpcCode, spec: LayeredSpec, R: int, TB: int,
                  D: int, NC: int, interpret: bool):
    Z, N = code.Z, code.N
    Zc = NC * R
    L = len(code.layers)
    sv = spec.sat_var

    def kernel(cols_ref, shifts_ref, degs_ref, mes_ref, moffs_ref, flags_ref,
               _app_in, app_ref, msg_ref, it_ref):
        pid = pl.program_id(0)
        # whole-array indexers on both axes (the Pallas interpreter does
        # not mix integer-array indexers with slices)
        lanes = (pid * TB
                 + jax.lax.broadcasted_iota(jnp.int32, (TB,), 0))[None, :]
        zi = jax.lax.broadcasted_iota(jnp.int32, (R,), 0)

        def layer(l, it, active):
            """One block-row for this tile; returns [TB] int32 unsat.
            Memory accesses are masked by row only (uniform along the
            contiguous codeword axis, so they stay vector accesses); a
            frozen codeword (``active`` 0) writes its old values back."""
            deg = degs_ref[l]
            me = mes_ref[l]
            moff = moffs_ref[l]
            cols = [cols_ref[l, e] for e in range(D)]
            shifts = [shifts_ref[l, e] for e in range(D)]
            warm = it > 0  # messages are all zero in the first iteration

            def chunk(c, unsat):
                z = c * R + zi
                fl = flags_ref[l, pl.ds(c * R, R)]
                commit = (fl & _COMMIT) != 0
                masked = (fl & _MASKED) != 0
                rows, olds, contribs = [], [], []
                for e in range(D):
                    zs = z + shifts[e]
                    zs = jnp.where(zs >= Z, zs - Z, zs)
                    ok = commit & (e < deg) & ~(masked & (me == e))
                    # rows that are off point at the spare rows past N, so
                    # no two rows of one access share an address
                    vrow = jnp.where(ok, cols[e] * Z + zs, N + zi)[:, None]
                    mrow = ((moff + e) * Zc + z)[:, None]
                    ok = ok[:, None]
                    v = plgpu.load(app_ref.at[vrow, lanes], mask=ok, other=0)
                    m = plgpu.load(msg_ref.at[mrow, lanes], mask=ok & warm,
                                   other=0)
                    cc = jnp.clip(v.astype(jnp.int32) - m.astype(jnp.int32),
                                  -sv, sv)
                    # an absent edge: -SAT_VAR is parity-neutral and never
                    # the min (see codes/code.py)
                    contribs.append(jnp.where(ok, cc, -sv))
                    rows.append((vrow, mrow, ok))
                    olds.append((v, m))
                msgs, parity = _cn_update(contribs, spec)
                for e in range(D):
                    vrow, mrow, ok = rows[e]
                    v_new = jnp.clip(contribs[e] + msgs[e], -sv, sv)
                    v_new, m_new = v_new.astype(jnp.int8), msgs[e].astype(
                        jnp.int8)
                    if active is not None:
                        on = active[None, :] != 0
                        v_new = jnp.where(on, v_new, olds[e][0])
                        m_new = jnp.where(on, m_new, olds[e][1])
                    plgpu.store(app_ref.at[vrow, lanes], v_new, mask=ok)
                    plgpu.store(msg_ref.at[mrow, lanes], m_new, mask=ok)
                par = jnp.where(commit[:, None], parity, 0)
                return jnp.maximum(unsat, jnp.max(par, axis=0))

            unsat = jax.lax.fori_loop(0, NC, chunk,
                                      jnp.zeros((TB,), jnp.int32))
            if not interpret:
                # the next layer reads APP rows that other threads wrote
                plgpu.debug_barrier()
            return unsat

        def iteration(it, active):
            return jax.lax.fori_loop(
                0, L, lambda l, u: jnp.maximum(u, layer(l, it, active)),
                jnp.zeros((TB,), jnp.int32))

        if spec.early_term:
            # a codeword freezes after the first iteration in which all of
            # its checks were satisfied; the tile stops when all have
            def cond(carry):
                it, active = carry
                return (it < spec.iters) & (jnp.max(active) > 0)

            def body(carry):
                it, active = carry
                unsat = iteration(it, active)
                return it + 1, active * (unsat > 0).astype(jnp.int32)

            it, _ = jax.lax.while_loop(
                cond, body, (jnp.int32(0), jnp.ones((TB,), jnp.int32)))
        else:
            def body(it, carry):
                iteration(it, None)
                return carry

            jax.lax.fori_loop(0, spec.iters, body, jnp.int32(0))
            it = jnp.int32(spec.iters)
        it_ref[pid] = it

    return kernel


def make_pallas_decoder(
    code: LdpcCode,
    spec: LayeredSpec = LayeredSpec(),
    batch_tile: int | None = None,
    interpret: bool = False,
):
    """Build ``decode(llr[B, N] int8) -> (bits[B, N] uint8, iters_used)``.

    ``iters_used`` is the largest iteration count of any tile (with early
    termination, the iterations the slowest codeword needed), the same
    number the XLA path reports.  ``batch_tile`` (codewords per program)
    overrides ``pick_batch_tile``.  ``interpret=True`` runs the kernel in
    the Pallas interpreter (CPU tests); otherwise a GPU is required.
    """
    if not pallas_supported(code, spec):
        raise ValueError(f"{code.name}: not all layers are QC block-rows")
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "backend 'pallas' is a GPU kernel; no GPU is visible to JAX "
            f"(default backend {jax.default_backend()!r})")
    R = pick_rows(code.Z)
    tabs, D, NC, n_slabs = _tables(code, R)
    tabs = tuple(jnp.asarray(t) for t in tabs)
    Zc = NC * R

    perm = inv_perm = None
    if code.col_perm is not None:
        perm = jnp.asarray(code.col_perm)
        ip = np.empty(code.N, dtype=np.int64)
        ip[code.col_perm] = np.arange(code.N)
        inv_perm = jnp.asarray(ip)

    def _call(app, TB: int):  # app [N + R, Bp] int8, Bp % TB == 0
        Bp = app.shape[1]
        nt = Bp // TB
        kernel = _build_kernel(code, spec, R, TB, D, NC, interpret)
        out_shape = (
            jax.ShapeDtypeStruct(app.shape, jnp.int8),
            jax.ShapeDtypeStruct((n_slabs * Zc, Bp), jnp.int8),
            jax.ShapeDtypeStruct((nt,), jnp.int32),
        )
        app, _, iters = pl.pallas_call(
            kernel,
            out_shape=out_shape,
            grid=(nt,),
            input_output_aliases={6: 0},
            compiler_params=plgpu.CompilerParams(
                num_warps=pick_num_warps(R, TB),
                num_stages=1),
            backend="triton",
            interpret=interpret,
            name="ldpc_layered_qc",
        )(*tabs, app)
        return app, iters.max()

    @jax.jit
    def decode(llr):
        llr = jnp.asarray(llr, jnp.int8)
        B0 = llr.shape[0]
        TB = batch_tile or pick_batch_tile(B0, R)
        if perm is not None:
            llr = llr[:, perm]  # QC-ified view: to QC column order
        # one call addresses at most _MAX_BUF bytes of messages
        per_frame = max(n_slabs * Zc, code.N)
        span = max(TB, (_MAX_BUF // per_frame) // TB * TB)
        apps, its = [], []
        for s in range(0, B0, span):
            part = llr[s: s + span]
            b = part.shape[0]
            pad = (-b) % TB
            # node-major [N + R, Bp]: R spare rows for switched-off rows
            app = jnp.pad(part, ((0, pad), (0, R))).T
            app, it = _call(app, TB)
            apps.append(app[: code.N, :b])
            its.append(it)
        app = jnp.concatenate(apps, axis=1) if len(apps) > 1 else apps[0]
        bits = (app > 0).astype(jnp.uint8).T
        if inv_perm is not None:
            bits = bits[:, inv_perm]
        return bits, jnp.max(jnp.stack(its)).astype(jnp.int32)

    return decode
