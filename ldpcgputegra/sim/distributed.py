"""Multi-host (multi-process) sharded Monte-Carlo sweep.

The reference's only "multi-device" axis is multiple CUDA streams on one
GPU (SURVEY §2.5); this is the multi-process replacement: every process
owns a slice of the global codeword batch, decode runs under a global
``jax.sharding`` mesh, and the (BE, FE) counters plus the early-exit vote
are global reductions XLA lowers to cross-device psums (NCCL on GPUs).  Process 0 drives the
sweep loop and reporting; all processes execute the same jitted step, so
no additional control traffic exists.

Launch (one command per process):

    python -m ldpcgputegra.sim.distributed \
        --coordinator HOST:PORT --num-processes N --process-id I \
        --code 1944x972 --snr 2.0 --batch 4096 --batches 10

Several processes on one host each take their own card: with a
``localhost`` coordinator, process I uses local device I (one JAX process
per card; a second process on a card would find its memory reserved).
"""

from __future__ import annotations

import argparse
from typing import Optional

import jax
import numpy as np

from ..channel.awgn import AwgnChannel, ChannelSpec
from ..codes.registry import load_code
from ..ops.layered import LayeredSpec
from ..parallel import decode_mesh, initialize_distributed, make_sharded_decoder
from .analyzer import ErrorAnalyzer

__all__ = ["run_distributed_point", "run_dp_tp_point"]


def run_distributed_point(
    code_name: str,
    snr_db: float,
    batch: int,
    batches: int,
    spec: LayeredSpec = LayeredSpec(),
    seed: int = 1234,
    mesh=None,
) -> Optional[ErrorAnalyzer]:
    """Decode ``batches`` global batches at one SNR on the global mesh.

    ``batch`` is the GLOBAL batch size (divisible by the device count).
    Returns the analyzer on process 0, None elsewhere.
    """
    code = load_code(code_name)
    mesh = mesh if mesh is not None else decode_mesh()
    step = make_sharded_decoder(code, spec, mesh)
    chan = AwgnChannel(code.N, code.K, ChannelSpec())
    sigma = chan.configure(snr_db)
    del sigma
    analyzer = ErrorAnalyzer(n=code.N, k=code.K)
    base = jax.random.key(seed)
    for k in range(batches):
        # every process generates the same global batch deterministically;
        # device_put inside the sharded step slices it onto local devices
        key = jax.random.fold_in(base, k)
        llr = chan.generate_zero_int8(key, batch)
        _, _, be, fe = step(llr)
        analyzer.add_counts(batch, int(be), int(fe))
    if jax.process_index() == 0:
        return analyzer
    return None


def run_dp_tp_point(
    code_name: str,
    snr_db: float,
    batch: int,
    batches: int,
    spec: LayeredSpec = LayeredSpec(),
    seed: int = 1234,
    dp: int = 2,
    tp: int = 4,
    mesh=None,
    checkpoint: Optional[str] = None,
) -> ErrorAnalyzer:
    """One Monte-Carlo SNR point through the composed ``(dp, tp)``
    topology (``parallel.rowshard.make_dp_tp_decoder``): the batch is
    dp-sharded while each codeword's Tanner graph is block-row-sharded
    over tp — the production topology for the giant DVB-S2 codes, driven
    by the REAL sweep loop semantics (deterministic per-batch channel
    keys, resumable counters) rather than a unit-test harness.

    Counters are bit-identical to a single-device sweep over the same
    keys: the decode is bit-exact under row sharding and the per-batch
    channel key schedule matches ``sweep.run_sweep``'s
    (``fold_in(fold_in(seed, 0), k)``).
    """
    import json
    import os

    from ..parallel.mesh import decode_mesh_2d
    from ..parallel.rowshard import make_dp_tp_decoder

    code = load_code(code_name)
    mesh = mesh if mesh is not None else decode_mesh_2d(dp, tp)
    step = make_dp_tp_decoder(code, spec, mesh)
    chan = AwgnChannel(code.N, code.K, ChannelSpec())
    chan.configure(snr_db)
    analyzer = ErrorAnalyzer(n=code.N, k=code.K)
    k0 = 0
    if checkpoint and os.path.exists(checkpoint):
        with open(checkpoint) as f:
            st = json.load(f)
        analyzer.add_counts(st["frames"], st["be"], st["fe"])
        k0 = st["batches"]
    base = jax.random.key(seed)
    for k in range(k0, batches):
        key = jax.random.fold_in(jax.random.fold_in(base, 0), k)
        llr = chan.generate_zero_int8(key, batch)
        _, _, be, fe = step(llr)
        analyzer.add_counts(batch, int(be), int(fe))
        if checkpoint:
            tmp = checkpoint + ".tmp"
            with open(tmp, "w") as f:
                json.dump({
                    "frames": analyzer.frames,
                    "be": analyzer.bit_errors,
                    "fe": analyzer.frame_errors,
                    "batches": k + 1,
                }, f)
            os.replace(tmp, checkpoint)
    return analyzer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--code", default="1944x972")
    ap.add_argument("--snr", type=float, default=2.0)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    one_host = (args.coordinator or "").split(":")[0] in (
        "localhost", "127.0.0.1")
    initialize_distributed(
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        local_device_ids=[args.process_id] if one_host else None,
    )
    spec = LayeredSpec(algo="OMS", iters=args.iters, early_term=True)
    res = run_distributed_point(
        args.code, args.snr, args.batch, args.batches, spec
    )
    if res is not None:
        print(
            f"(II) processes={jax.process_count()} devices={jax.device_count()}"
        )
        print(
            f"RESULT frames={res.frames} be={res.bit_errors} "
            f"fe={res.frame_errors} ber={res.ber:.3e} fer={res.fer:.3e}"
        )


if __name__ == "__main__":
    main()
