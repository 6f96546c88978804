"""Tanner-graph (block-row) sharding: ONE codeword decoded across devices.

The reference never splits a codeword — every frame decodes entirely on
one device; its only parallel axes are frame batching and host streams
(SURVEY §2.5).  This module implements the one axis SURVEY designs that
has no reference counterpart: the TP analogue for the giant DVB-S2 codes,
where a single 64800-bit codeword's check workload is sharded over the
mesh and devices exchange partial APP updates ("partial syndromes") per
layer.

Mechanics (shard_map over the ``dp`` axis, D devices):

* the APP array ``V3 [Nb, Z, B]`` is REPLICATED; every device processes
  its Z/D slice of each QC block-row's checks (checks within a block-row
  touch pairwise-disjoint VNs, so device slices commute exactly);
* each device computes int32 APP DELTAS for its rows (zero outside its
  slice, zero at deficient-circulant-masked and non-committed sub-pass
  rows, zero for early-term-frozen codewords); one ``psum`` per layer
  merges the disjoint deltas — integer adds, bit-exact, the only cross-device
  traffic (``deg x Z x B`` ints per layer);
* c2v messages stay device-local (``[deg, Z/D, B]`` per layer) — they are
  never exchanged, exactly like the reference keeps messages in
  device-private memory;
* early termination: per-layer local parity ORs are psum'd into a global
  per-codeword vote (the cross-chip generalisation of EARLY_TERM's
  block-local ``ov_sign``, ``CUDA_MS_SIMD.cu:242-245``).

Decoded bits are bit-exact vs the single-device layered decoder on the
same (QC-view) schedule: device slices of a block-row are disjoint, delta
merging is integer addition, and sub-pass ordering is preserved
(validated in ``tests/test_rowshard.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..codes.code import LdpcCode
from ..codes.schedule import build_layers
from ..ops.layered import LayeredSpec, _cn_update, _roll
from .mesh import BATCH_AXIS, TP_AXIS

__all__ = [
    "make_rowsharded_decoder",
    "make_dp_tp_decoder",
    "rowshard_supported",
]

_CT = jnp.int16
_ST = jnp.int8


def rowshard_supported(
    code: LdpcCode, n_devices: int, schedule: str = "auto"
) -> bool:
    """All layers of the requested schedule must be QC block-rows with Z
    divisible by the mesh."""
    from ..decoder import effective_code

    code = effective_code(code)
    if code.Z is None or code.Z % n_devices:
        return False
    return all(l.qc is not None for l in build_layers(code, schedule))


def _slice_rows(arr, r0, zd):
    """Dynamic Z-slice [r0:r0+zd] along axis 0."""
    return jax.lax.dynamic_slice_in_dim(arr, r0, zd, axis=0)


def _layer_step_sharded(V3, msg, layer, spec: LayeredSpec, r0, zd, active,
                        axis_name):
    """One QC block-row, this device's Z/D rows; returns (V3, msg, parity).

    ``msg`` is the local [deg, zd, B] int8 slab; parity is local [zd, B].
    """
    cols = layer.qc.cols.tolist()
    shifts = layer.qc.shifts.tolist()
    Z = layer.n_checks
    deg = layer.deg
    sv = spec.sat_var
    me = layer.qc.mask_edge
    mrow = None
    if me is not None:
        m_np = np.zeros((Z, 1), dtype=bool)
        m_np[layer.qc.mask_rows] = True
        mrow = _slice_rows(jnp.asarray(m_np), r0, zd)
    cmask = None
    if layer.qc.commit_rows is not None:
        c_np = np.zeros((Z, 1), dtype=bool)
        c_np[layer.qc.commit_rows] = True
        cmask = _slice_rows(jnp.asarray(c_np), r0, zd)

    rolled = [_roll(V3[cols[j]], shifts[j]) for j in range(deg)]  # [Z, B]
    rolled_loc = [_slice_rows(r, r0, zd) for r in rolled]  # [zd, B]
    contribs = [
        jnp.clip(rolled_loc[j].astype(_CT) - msg[j].astype(_CT), -sv, sv)
        for j in range(deg)
    ]
    if me is not None:
        contribs[me] = jnp.where(mrow, jnp.asarray(-sv, _CT), contribs[me])
    new_msgs, parity = _cn_update(contribs, spec)
    deltas = []
    out_msg = []
    for j in range(deg):
        v_new = jnp.clip(contribs[j] + new_msgs[j], -sv, sv)
        m_new = new_msgs[j].astype(_ST)
        allowed = None  # None == every local row commits
        if active is not None:
            allowed = jnp.broadcast_to(active[None, :], (zd, v_new.shape[1]))
        if me is not None and j == me:
            blocked = jnp.broadcast_to(mrow, v_new.shape)
            allowed = ~blocked if allowed is None else (allowed & ~blocked)
        if cmask is not None:
            cm = jnp.broadcast_to(cmask, v_new.shape)
            allowed = cm if allowed is None else (allowed & cm)
        delta_loc = v_new - rolled_loc[j].astype(_CT)
        if allowed is not None:
            delta_loc = jnp.where(allowed, delta_loc, 0)
            m_new = jnp.where(allowed, m_new, msg[j])
        deltas.append(delta_loc)
        out_msg.append(m_new)
    # place local deltas into the full [deg, Z, B] slab and merge over the
    # mesh: devices' rows are disjoint, so psum IS the exact union
    delta_full = jnp.zeros((deg, Z, V3.shape[-1]), _CT)
    delta_full = jax.lax.dynamic_update_slice_in_dim(
        delta_full, jnp.stack(deltas), r0, axis=1
    )
    delta_full = jax.lax.psum(delta_full, axis_name)
    # apply per block-column; repeated columns just add twice (deltas of
    # distinct edges touch disjoint VNs, so the adds never overlap)
    col_edges: dict[int, list[int]] = {}
    for j in range(deg):
        col_edges.setdefault(cols[j], []).append(j)
    for col, js in col_edges.items():
        slab = V3[col].astype(_CT)
        for j in js:
            slab = slab + _roll(delta_full[j], (-shifts[j]) % Z)
        V3 = V3.at[col].set(slab.astype(_ST))
    if cmask is not None:
        parity = jnp.where(cmask, parity, 0)
    return V3, jnp.stack(out_msg), parity


def _make_local_decode(code: LdpcCode, spec: LayeredSpec, D: int,
                       axis_name: str):
    """Build the per-device decode body: this device owns Z/D rows of
    every QC block-row, exchanging deltas over mesh axis ``axis_name``.

    ``code`` must already be the effective (QC-view) code.
    """
    # layer order must match make_layered_decoder's for the same spec —
    # fixed-point layered min-sum is schedule-order-sensitive, so the
    # bit-exactness contract depends on honoring spec.schedule here
    assert rowshard_supported(code, D, spec.schedule), (
        f"{code.name}: not row-shardable under schedule {spec.schedule!r}"
    )
    layers = tuple(build_layers(code, spec.schedule))
    Z = code.Z
    Nb = code.N // Z
    zd = Z // D
    perm = inv_perm = None
    if code.col_perm is not None:
        perm = jnp.asarray(code.col_perm)
        ip = np.empty(code.N, dtype=np.int64)
        ip[code.col_perm] = np.arange(code.N)
        inv_perm = jnp.asarray(ip)

    def local_decode(llr):  # llr [B, N] tp-replicated, inside shard_map
        di = jax.lax.axis_index(axis_name)
        r0 = di * zd
        llr = jnp.asarray(llr, _ST)
        if perm is not None:
            llr = llr[:, perm]
        B = llr.shape[0]
        V3 = llr.T.reshape(Nb, Z, B)
        msgs0 = tuple(jnp.zeros((l.deg, zd, B), _ST) for l in layers)

        def iteration(V3, msgs, active):
            unsat = None
            out = []
            for li, layer in enumerate(layers):
                V3, m, parity = _layer_step_sharded(
                    V3, msgs[li], layer, spec, r0, zd, active, axis_name
                )
                out.append(m)
                lay_un = jnp.any(parity != 0, axis=0)  # local [B]
                unsat = lay_un if unsat is None else (unsat | lay_un)
            # global per-codeword convergence vote (partial-syndrome OR)
            unsat = jax.lax.psum(unsat.astype(jnp.int32), axis_name) > 0
            return V3, tuple(out), unsat

        if not spec.early_term:
            def body(carry, _):
                V3, msgs = carry
                V3, msgs, _ = iteration(V3, msgs, None)
                return (V3, msgs), None

            (V3, _), _ = jax.lax.scan(
                body, (V3, msgs0), None, length=spec.iters
            )
            iters_used = jnp.asarray(spec.iters, jnp.int32)
        else:
            def cond(c):
                _, _, it, unsat = c
                return jnp.any(unsat) & (it < spec.iters)

            def body(c):
                V3, msgs, it, unsat = c
                V3, msgs, unsat2 = iteration(V3, msgs, unsat)
                return (V3, msgs, it + 1, unsat & unsat2)

            V3, msgs1, unsat0 = iteration(V3, msgs0, None)
            V3, _, iters_used, _ = jax.lax.while_loop(
                cond, body, (V3, msgs1, jnp.asarray(1, jnp.int32), unsat0)
            )
        bits = (V3.reshape(code.N, B) > 0).astype(jnp.uint8).T
        if inv_perm is not None:
            bits = bits[:, inv_perm]
        return bits, iters_used

    return local_decode


def make_rowsharded_decoder(
    code: LdpcCode,
    spec: LayeredSpec,
    mesh: Mesh,
):
    """Build ``decode(llr[B, N] int8) -> (bits[B, N] uint8, iters_used)``
    where each codeword's Tanner graph is sharded over the whole mesh.

    ``B`` is typically tiny (this is the latency/TP axis, not the batch
    axis); bits come back replicated.
    """
    from ..decoder import effective_code

    code = effective_code(code)
    # whole-mesh sharding needs a single axis: with more axes, axis_index/
    # psum would span only one of them while D spans all, silently merging
    # a fraction of the row slices — use make_dp_tp_decoder for 2-D meshes
    assert len(mesh.axis_names) == 1, (
        f"make_rowsharded_decoder shards over the WHOLE mesh and requires "
        f"a 1-D mesh, got axes {mesh.axis_names}; use make_dp_tp_decoder "
        f"for a (dp, tp) mesh"
    )
    D = int(np.prod(list(mesh.shape.values())))
    local_decode = _make_local_decode(code, spec, D, mesh.axis_names[0])
    mapped = jax.shard_map(
        local_decode,
        mesh=mesh,
        in_specs=(P(),),
        out_specs=(P(), P()),
        # messages are device-local state (deliberately shard-varying)
        check_vma=False,
    )
    return jax.jit(mapped)


def make_dp_tp_decoder(
    code: LdpcCode,
    spec: LayeredSpec,
    mesh: Mesh,
    count_errors: bool = True,
):
    """DPxTP composition over a 2-D ``(dp, tp)`` mesh
    (``mesh.decode_mesh_2d``): the codeword batch is sharded over ``dp``
    while each codeword's Tanner graph is block-row-sharded over ``tp``.

    This is the production topology for the giant DVB-S2 codes — the two
    parallel axes SURVEY §2.5 designs, composed: frames scale out like the
    reference's streams (P2/P3), the graph scales in like nothing the
    reference has.  Returns
    ``step(llr[B, N], ref_bits?) -> (bits, iters_used[, be, fe])`` with
    ``bits`` dp-sharded and counters/iters replicated (psum over dp; the
    tp vote already lives inside the decode).
    """
    from ..decoder import effective_code

    assert BATCH_AXIS in mesh.shape and TP_AXIS in mesh.shape, (
        f"mesh must have ({BATCH_AXIS!r}, {TP_AXIS!r}) axes, "
        f"got {mesh.axis_names}"
    )
    code_eff = effective_code(code)
    local_decode = _make_local_decode(
        code_eff, spec, int(mesh.shape[TP_AXIS]), TP_AXIS
    )

    def local_step(llr, ref_bits):
        bits, iters_used = local_decode(llr)  # tp-collective inside
        iters_used = jax.lax.pmax(iters_used, BATCH_AXIS)
        if not count_errors:
            return bits, iters_used
        err = (bits != ref_bits).astype(jnp.int32)
        be_per_frame = err.sum(axis=1)
        be = jax.lax.psum(be_per_frame.sum(), BATCH_AXIS)
        fe = jax.lax.psum(
            (be_per_frame != 0).astype(jnp.int32).sum(), BATCH_AXIS
        )
        return bits, iters_used, be, fe

    out_specs = (
        (P(BATCH_AXIS, None), P())
        if not count_errors
        else (P(BATCH_AXIS, None), P(), P(), P())
    )
    mapped = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(BATCH_AXIS, None), P(BATCH_AXIS, None)),
        out_specs=out_specs,
        # per-device message state is deliberately shard-varying
        check_vma=False,
    )
    jitted = jax.jit(mapped)
    batch_sharding = NamedSharding(mesh, P(BATCH_AXIS, None))

    def run(llr, ref_bits=None):
        llr = jax.device_put(llr, batch_sharding)
        if ref_bits is None:
            ref_bits = jnp.zeros(llr.shape, jnp.uint8)
        ref_bits = jax.device_put(
            jnp.asarray(ref_bits, jnp.uint8), batch_sharding
        )
        return jitted(llr, ref_bits)

    return run
