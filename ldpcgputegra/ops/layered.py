"""Batched layered min-sum decoding as XLA-native JAX.

Batched re-expression of the reference decode kernels
(``code/gpu_fixed/decoder_ms/cuda/CUDA_MS_SIMD.cu:25-248`` and the scalar
oracle ``CDecoder_OMS_fixed_x86.cpp:60-150``):

* codewords ride the lane (last) axis — the analogue of the reference's
  4-codeword int8x4 SIMD packing x 128-thread blocks (P1/P2 parallelism);
* the layered schedule's in-place APP update is preserved by processing
  conflict-free layers sequentially; every check inside a layer touches
  disjoint VNs, so vectorizing a layer is bit-identical to the reference's
  strictly sequential check loop;
* QC layers replace data-dependent gathers with *static cyclic rolls*
  (slice+concat), which XLA lowers to cheap vector shuffles: edge position j
  of check z reads VN ``col_j*Z + (shift_j+z) % Z``, i.e. the block-column
  slab rolled by ``shift_j``;
* non-QC layers use one static row-gather/scatter per layer;
* iteration loop is a ``lax.scan`` (fixed iters) or ``lax.while_loop``
  (early termination, per-codeword frozen updates — the generalisation of
  EARLY_TERM's per-thread break at ``CUDA_2NMS_SIMD.cu:17``).

All arithmetic is int16 on int8-stored state; saturation bounds default
to the reference's SAT_VAR=127 / SAT_MSG=31 (``constantes_sse.h:43-49``)
and are configurable per spec (the -var/-msg flags).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.code import Layer, LdpcCode
from ..codes.schedule import build_layers
from ..golden.decoder import SAT_MSG, SAT_VAR

__all__ = ["LayeredSpec", "make_layered_decoder"]

_CT = jnp.int16  # compute dtype
_ST = jnp.int8  # storage dtype


@dataclasses.dataclass(frozen=True)
class LayeredSpec:
    """Static decode configuration (hashable: usable as a jit static arg)."""

    algo: str = "OMS"  # MS | OMS | NMS | 2NMS
    iters: int = 10
    offset: int = 1
    early_term: bool = False
    minclamp: str = "pre"  # 'pre' = x86 oracle, 'post' = GPU kernels
    schedule: str = "auto"  # reference | colored | auto
    # NMS normalization factors in 1/32 units (the reference's x86 fixed
    # path: `-NMS <factor>` -> VECTOR_MUL + DIV32, default 29 in main_p.cpp
    # :136; the CUDA kernels hard-code 24 (=0.75) and 28 (=0.875), which
    # are the defaults here).  nms_f scales min1 (and min2 for plain NMS);
    # nms_f2 scales min2 in 2NMS.
    nms_f: int = 24
    nms_f2: int = 28
    # configurable quantization ranges (-var/-msg; setVarRange/setMsgRange)
    sat_var: int = SAT_VAR
    sat_msg: int = SAT_MSG

    def __post_init__(self) -> None:
        # Every accelerated path stores APP/messages as int8; wider ranges
        # would silently wrap on the int8 stores while the int64 golden
        # model stays correct.  Refuse instead of diverging.
        if not (0 < self.sat_var <= 127):
            raise ValueError(
                f"sat_var={self.sat_var}: accelerated paths store APP as "
                "int8, so var quantizer width is limited to 8 bits "
                "(sat_var <= 127)"
            )
        if not (0 < self.sat_msg <= 127):
            raise ValueError(
                f"sat_msg={self.sat_msg}: accelerated paths store messages "
                "as int8, so msg quantizer width is limited to 8 bits "
                "(sat_msg <= 127)"
            )
        if not (0 < self.nms_f <= 32 and 0 < self.nms_f2 <= 32):
            raise ValueError(
                f"nms_f={self.nms_f}, nms_f2={self.nms_f2}: NMS factors "
                "are 1/32 units in (0, 32] (1.0 max, like the reference's "
                "DIV32 fixed path)"
            )


def _f_consts(min1, min2, spec: LayeredSpec):
    """Message magnitudes (f1 for the min edge, f2 for the rest).

    Integer-exact forms of the reference variants: OMS subtract-offset with
    underflow-to-zero (vsubus4, CUDA_OMS_SIMD.cu:73-74); NMS/2NMS float
    multiply-truncate (CUDA_NMS_SIMD.cu:73-85) == (x*3)>>2 and (x*7)>>3 for
    non-negative ints; MS plain 31-saturation (CUDA_MS_SIMD.cu:73-74).
    """
    if spec.algo == "MS":
        return (
            jnp.minimum(min2, spec.sat_msg),
            jnp.minimum(min1, spec.sat_msg),
        )
    if spec.algo == "OMS":
        f1 = jnp.minimum(jnp.maximum(min2 - spec.offset, 0), spec.sat_msg)
        f2 = jnp.minimum(jnp.maximum(min1 - spec.offset, 0), spec.sat_msg)
        return f1, f2
    if spec.algo == "NMS":
        return (min2 * spec.nms_f) >> 5, (min1 * spec.nms_f) >> 5
    if spec.algo == "2NMS":
        return (min2 * spec.nms_f2) >> 5, (min1 * spec.nms_f) >> 5
    raise ValueError(f"unknown algo {spec.algo!r}")


def _roll(x, s: int):
    """Static cyclic roll along axis 0 (slice+concat; no gather)."""
    if s == 0:
        return x
    return jnp.concatenate([x[s:], x[:s]], axis=0)


def _cn_update(contribs: list, spec: LayeredSpec):
    """Check-node core on a list of [**, B] int16 contribution tensors.

    Returns (new messages list, parity) — parity is the XOR of contribution
    signs (1 bit per check per codeword), 0 when the check is satisfied.
    """
    big = jnp.asarray(spec.sat_var + 1, _CT)
    min1 = None
    min2 = None
    sgns = []
    mags = []
    for c in contribs:
        a = (
            jnp.abs(jnp.clip(c, -spec.sat_msg, spec.sat_msg))
            if spec.minclamp == "pre"
            else jnp.abs(c)
        )
        mags.append(a)
        sgns.append((c > 0).astype(_CT))
        if min1 is None:
            min1, min2 = a, jnp.broadcast_to(big, a.shape)
        else:
            # running two-min, order-identical to CUDA_MS_SIMD.cu:168-170
            min2 = jnp.minimum(min2, jnp.maximum(a, min1))
            min1 = jnp.minimum(min1, a)
    parity = sgns[0]
    for s in sgns[1:]:
        parity = parity ^ s
    f1, f2 = _f_consts(min1, min2, spec)
    new_msgs = []
    for a, c, s in zip(mags, contribs, sgns):
        mag = jnp.where(a == min1, f1, f2)
        m = jnp.where((parity ^ s) == 1, mag, -mag)
        if spec.minclamp == "pre":
            m = jnp.clip(m, -spec.sat_msg, spec.sat_msg)
        new_msgs.append(m)
    return new_msgs, parity


def _layer_step_qc(V3, msg, layer: Layer, spec: LayeredSpec, active=None):
    """One QC block-row. V3: [Nb, Z, B] int8; msg: [deg, Z, B] int8.

    ``active`` (when early-terminating) is a [B] bool mask; rows of
    converged codewords are written back unchanged.  A deficient-circulant
    edge (``qc.mask_edge``) has its masked checks' contribution pinned to
    -SAT_VAR (parity-neutral, never the min) and its writebacks suppressed
    — exactly equivalent to the edge being absent (see codes/code.py).
    """
    cols = layer.qc.cols.tolist()
    shifts = layer.qc.shifts.tolist()
    Z = layer.n_checks
    deg = layer.deg
    me = layer.qc.mask_edge
    mrow = None
    if me is not None:
        m_np = np.zeros((Z, 1), dtype=bool)
        m_np[layer.qc.mask_rows] = True
        mrow = jnp.asarray(m_np)
    cmask = None
    if layer.qc.commit_rows is not None:
        c_np = np.zeros((Z, 1), dtype=bool)
        c_np[layer.qc.commit_rows] = True
        cmask = jnp.asarray(c_np)  # sub-pass: only these checks commit
    rolled = [_roll(V3[cols[j]], shifts[j]) for j in range(deg)]
    sv = spec.sat_var
    contribs = [
        jnp.clip(rolled[j].astype(_CT) - msg[j].astype(_CT), -sv, sv)
        for j in range(deg)
    ]
    if me is not None:
        contribs[me] = jnp.where(mrow, jnp.asarray(-sv, _CT), contribs[me])
    new_msgs, parity = _cn_update(contribs, spec)
    out_msg = []
    v_news = []
    upd_masks = []  # [Z, B]-broadcastable "this position truly updates"
    for j in range(deg):
        v_new = jnp.clip(contribs[j] + new_msgs[j], -sv, sv).astype(_ST)
        m_new = new_msgs[j].astype(_ST)
        upd = None  # None == all rows/lanes update
        if active is not None:
            v_new = jnp.where(active[None, :], v_new, rolled[j])
            m_new = jnp.where(active[None, :], m_new, msg[j])
            upd = active[None, :]
        if me is not None and j == me:
            v_new = jnp.where(mrow, rolled[j], v_new)
            m_new = jnp.where(mrow, msg[j], m_new)
            upd = ~mrow if upd is None else (upd & ~mrow)
        if cmask is not None:
            v_new = jnp.where(cmask, v_new, rolled[j])
            m_new = jnp.where(cmask, m_new, msg[j])
            upd = cmask if upd is None else (upd & cmask)
        v_news.append(v_new)
        upd_masks.append(upd)
        out_msg.append(m_new)
    # Writeback.  A repeated block-column needs a MERGED write: each edge's
    # full-slab store would otherwise clobber the other edge's committed
    # updates to the same column (both are computed from the sub-pass-start
    # slab).  Updates of distinct edges within a conflict-free group touch
    # disjoint VNs, so sequential where-merges are exact.
    col_edges: dict[int, list[int]] = {}
    for j in range(deg):
        col_edges.setdefault(cols[j], []).append(j)
    for col, js in col_edges.items():
        if len(js) == 1:
            j = js[0]
            V3 = V3.at[col].set(_roll(v_news[j], (-shifts[j]) % Z))
        else:
            slab = V3[col]
            for j in js:
                back = _roll(v_news[j], (-shifts[j]) % Z)
                upd = upd_masks[j]
                if upd is None:
                    slab = back
                else:
                    upd_b = jnp.broadcast_to(upd, (Z, slab.shape[1]))
                    slab = jnp.where(
                        _roll(upd_b, (-shifts[j]) % Z), back, slab
                    )
            V3 = V3.at[col].set(slab)
    if cmask is not None:
        # only committed checks' syndromes are meaningful this sub-pass
        parity = jnp.where(cmask, parity, 0)
    return V3, jnp.stack(out_msg), parity


def _layer_step_gather(V, msg, layer: Layer, spec: LayeredSpec, active=None):
    """One general conflict-free layer. V: [N, B]; msg: [deg, G, B]."""
    idx = jnp.asarray(layer.idx.T)  # [deg, G] static constants
    deg, G = idx.shape
    gathered = V[idx.reshape(-1)].reshape(deg, G, -1).astype(_CT)
    sv = spec.sat_var
    contribs = [
        jnp.clip(gathered[j] - msg[j].astype(_CT), -sv, sv)
        for j in range(deg)
    ]
    new_msgs, parity = _cn_update(contribs, spec)
    v_new = jnp.stack(
        [jnp.clip(contribs[j] + new_msgs[j], -sv, sv) for j in range(deg)]
    ).astype(_ST)
    m_new = jnp.stack(new_msgs).astype(_ST)
    if active is not None:
        v_new = jnp.where(active[None, None, :], v_new, gathered.astype(_ST))
        m_new = jnp.where(active[None, None, :], m_new, msg)
    V = V.at[idx.reshape(-1)].set(
        v_new.reshape(deg * G, -1),
        unique_indices=True,
        mode="promise_in_bounds",
    )
    return V, m_new, parity


def _iteration(V, msgs, layers: Sequence[Layer], spec: LayeredSpec,
               qc_shape, active=None):
    """One full layered iteration; returns (V, msgs, unsatisfied[B])."""
    unsat = None
    new_msgs = []
    use_qc = qc_shape is not None
    if use_qc:
        # the barrier stops XLA from fusing this reshape into the layer
        # update chain — that fusion MISCOMPILES (observed on CPU XLA:
        # wrong APP values on codes with sub-pass layers; a single barrier
        # here restores bit-exactness, see tests/test_dvbs2_qc.py; GPU
        # XLA is bit-exact with it on the 64800x21600 sub-pass view)
        V = jax.lax.optimization_barrier(V.reshape(qc_shape))
    for li, layer in enumerate(layers):
        if use_qc and layer.qc is not None:
            V, m, parity = _layer_step_qc(V, msgs[li], layer, spec, active)
        else:
            if use_qc:
                V = V.reshape(qc_shape[0] * qc_shape[1], qc_shape[2])
            V, m, parity = _layer_step_gather(V, msgs[li], layer, spec, active)
            if use_qc:
                V = V.reshape(qc_shape)
        new_msgs.append(m)
        lay_unsat = jnp.any(parity != 0, axis=0)  # [B]
        unsat = lay_unsat if unsat is None else (unsat | lay_unsat)
    if use_qc:
        V = V.reshape(qc_shape[0] * qc_shape[1], qc_shape[2])
    return V, tuple(new_msgs), unsat


def make_layered_decoder(
    code: LdpcCode,
    spec: LayeredSpec = LayeredSpec(),
    node_major: bool = False,
):
    """Build a jittable batched decoder.

    Returns ``decode(llr_int8) -> (bits_uint8, iters_used)``; llr/bits are
    frame-major [B, N] unless ``node_major`` (then [N, B], skipping the
    interleave transposes — the reference's Interleaver_uint8 equivalent,
    ``GPU_Transpose_uint8.cu:9-130``).
    """
    layers = tuple(build_layers(code, spec.schedule))
    all_qc = code.Z is not None and all(l.qc is not None for l in layers)
    qc_shape = None
    if all_qc:
        qc_shape = (code.N // code.Z, code.Z)
    perm = inv_perm = None
    if code.col_perm is not None:
        perm = jnp.asarray(code.col_perm)
        ip = np.empty(code.N, dtype=np.int64)
        ip[code.col_perm] = np.arange(code.N)
        inv_perm = jnp.asarray(ip)

    def decode(llr: jax.Array):
        llr = jnp.asarray(llr, _ST)
        if perm is not None:
            # QC-ified view of a base code: permute LLRs into QC column
            # order (and bits back at the end, below)
            llr = llr[:, perm] if not node_major else llr[perm, :]
        if node_major:
            V = llr
        else:
            V = llr.T  # interleave: frame-major -> node-major
        B = V.shape[1]
        shape3 = (*qc_shape, B) if qc_shape else None
        msgs0 = tuple(
            jnp.zeros((l.deg, l.n_checks, B), _ST) for l in layers
        )

        if not spec.early_term:
            def body(carry, _):
                V, msgs = carry
                V, msgs, _ = _iteration(V, msgs, layers, spec, shape3)
                return (V, msgs), None

            (V_fin, _), _ = jax.lax.scan(
                body, (V, msgs0), None, length=spec.iters
            )
            iters_used = jnp.asarray(spec.iters, jnp.int32)
        else:
            def cond(carry):
                _, _, it, unsat = carry
                return jnp.any(unsat) & (it < spec.iters)

            def body(carry):
                V, msgs, it, unsat = carry
                # freeze converged codewords: their APP/messages stop
                # changing — per-codeword generalisation of the reference's
                # per-thread EARLY_TERM break (CUDA_2NMS_SIMD.cu:17)
                V2, msgs2, unsat2 = _iteration(
                    V, msgs, layers, spec, shape3, active=unsat
                )
                return (V2, msgs2, it + 1, unsat & unsat2)

            # first iteration always runs (messages start at zero)
            V, msgs, unsat0 = _iteration(V, msgs0, layers, spec, shape3)
            carry = (V, msgs, jnp.asarray(1, jnp.int32), unsat0)
            V_fin, _, iters_used, _ = jax.lax.while_loop(cond, body, carry)

        bits = (V_fin > 0).astype(jnp.uint8)
        if not node_major:
            bits = bits.T  # deinterleave + hard decision fused
        if inv_perm is not None:
            bits = bits[:, inv_perm] if not node_major else bits[inv_perm, :]
        return bits, iters_used

    return jax.jit(decode)
