"""Batch-sharded decode step over a device mesh (shard_map SPMD).

The codeword batch is laid out over the mesh ``dp`` axis with
``shard_map``: every device runs the *full one-device decoder* (the Pallas
kernel included — a custom call cannot be auto-partitioned, so manual SPMD
keeps the fused kernel under multi-device execution) on its local shard,
then the (BE, FE) counters are summed with an explicit ``lax.psum`` — the
collective structure SURVEY §5.8 prescribes as the replacement for the
reference's shared-memory ``CErrorAnalyzer::accumulate``
(``CErrorAnalyzer.cpp:87-92``).

Early termination stays shard-local: codeword freezing is per codeword, so
decoded bits are independent of the vote granularity, and a local vote
needs no extra synchronization per iteration;
``iters_used`` is pmax'd so the reported count equals the global-vote
number.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..codes.code import LdpcCode
from ..ops.layered import LayeredSpec
from .mesh import BATCH_AXIS

__all__ = ["make_sharded_decoder"]


def make_sharded_decoder(
    code: LdpcCode,
    spec: LayeredSpec,
    mesh: Mesh,
    count_errors: bool = True,
    backend: str = "auto",
):
    """Build ``step(llr[B,N], ref_bits?) -> (bits, iters_used, be, fe)``.

    ``llr`` is placed (or re-laid-out) as batch-sharded over ``dp``; the
    decoded bits come back with the same sharding, counters as replicated
    scalars.  ``ref_bits=None`` counts against the all-zero codeword.
    """
    from ..decoder import make_decoder

    inner = make_decoder(code, spec, backend=backend)
    batch_sharding = NamedSharding(mesh, P(BATCH_AXIS, None))

    def local_step(llr: jax.Array, ref_bits: jax.Array):
        bits, iters_used = inner(llr)
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
        # the decoder's zero-initialized message carries are replicated
        # constants that become shard-varying after one iteration; that is
        # intentional (per-shard state), so skip the varying-axes check
        check_vma=False,
    )
    jitted = jax.jit(mapped)

    def run(llr, ref_bits: Optional[jax.Array] = None):
        llr = jax.device_put(llr, batch_sharding)
        if ref_bits is None:
            ref_bits = jnp.zeros(llr.shape, jnp.uint8)
        ref_bits = jax.device_put(
            jnp.asarray(ref_bits, jnp.uint8), batch_sharding
        )
        return jitted(llr, ref_bits)

    return run
