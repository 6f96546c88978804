"""Multi-device / multi-host execution (reference P1-P5 re-expressed).

The reference's only parallel axes are frame batching (SIMD lanes x SIMT
threads) and host-side multi-stream overlap (``code/gpu_fixed/test.cpp:
345-420``); "multi-device" never leaves one GPU.  Here the same axes map
onto a device mesh (SURVEY §2.5, §5.8):

* DP — the codeword batch is sharded over a ``jax.sharding.Mesh`` axis;
  decoding is embarrassingly parallel, so no collective traffic exists in
  steady state;
* the error/convergence counters are global reductions — XLA inserts
  ``psum`` (NCCL between GPUs) for the (BE, FE) sums and for the aggregate
  early-termination vote (the cross-chip generalisation of EARLY_TERM's
  block-local sign-OR, ``CUDA_MS_SIMD.cu:242-245``);
* TP — the one axis the reference never has: a single codeword's Tanner
  graph block-row-sharded over the mesh (``rowshard``), with per-layer
  partial-APP-delta psums; composable with DP on a 2-D ``(dp, tp)`` mesh
  (``make_dp_tp_decoder``);
* multi-host: `initialize_distributed` wires `jax.distributed`, and the
  same sharded decode runs over the global device set.
"""

from .mesh import (
    decode_mesh,
    decode_mesh_2d,
    initialize_distributed,
    local_batch_size,
)
from .rowshard import make_dp_tp_decoder, make_rowsharded_decoder
from .sharded import make_sharded_decoder

__all__ = [
    "decode_mesh",
    "decode_mesh_2d",
    "initialize_distributed",
    "local_batch_size",
    "make_dp_tp_decoder",
    "make_rowsharded_decoder",
    "make_sharded_decoder",
]
