#!/usr/bin/env python3
"""Smoke run of the decoder and the Monte-Carlo path on one NVIDIA GPU.

    python chip_smoke.py               # every one-card phase
    python chip_smoke.py --four-cards  # only the multi-card path, 4 GPUs

Each decode phase builds decoders through ``make_decoder`` at a real code
size and batch, times the hand-written kernel and the plain XLA path in
alternating ``block_until_ready`` windows, and checks the decoded bits and
the iteration count against the golden oracle (integer decoder: zero bits
of tolerance).  The sweep phase runs one SNR point of ``run_sweep`` on the
GPU and on the host CPU with the same seed and compares the frame error
rates within 3 sigma of the binomial (the channel is float math, so the two
devices may round differently).  One line of results per phase; the last
line is ``{"ok": true, "device": {...}}`` and is printed only when every
phase passed.  With no GPU the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np


def card_line() -> str:
    """Name and power limit of the card, read by a child that stays off
    JAX (a rate without the power limit cannot be compared)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def channel_llrs(code, batch: int, ebn0_db: float, seed: int) -> np.ndarray:
    """Quantized BPSK/AWGN LLRs of the all-zero codeword, made on the host
    (the channel's clamp(8*y, +/-31) quantizer)."""
    from ldpcgputegra.channel.awgn import sigma_for_snr

    sigma = sigma_for_snr(ebn0_db, code.K / code.N)
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((batch, code.N), dtype=np.float32)
    y = -1.0 + np.float32(sigma) * y
    return np.clip(np.trunc(8.0 * y), -31, 31).astype(np.int8)


def golden(code, llr: np.ndarray, spec):
    """Golden-oracle decode of ``llr`` in the decoders' schedule order
    (native C++ oracle, NumPy fallback)."""
    from ldpcgputegra.golden import decode_scheduled, params_for

    return decode_scheduled(code, llr, params_for(spec), spec.schedule)


def _peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def decode_phase(name: str, batch: int, *, algo: str = "OMS",
                 iters: int = 10, early_term: bool = False,
                 ebn0_db: float = 2.0, n_check: int = 64,
                 seed: int = 0, windows: int = 5,
                 backends: tuple = (), interpret: bool = False) -> dict:
    """Decode one batch of ``name`` through ``make_decoder``: the ``auto``
    choice and, for QC codes, both the kernel and the XLA path.  Every
    backend's bits must equal the golden oracle's on the first ``n_check``
    frames (on every frame with early termination, where the reported
    iteration count must equal the oracle's largest).  ``backends``
    overrides that list; ``interpret=True`` runs the kernel in the Pallas
    interpreter (CPU tests)."""
    import jax

    from ldpcgputegra.bench import measure_call
    from ldpcgputegra.codes.registry import load_code
    from ldpcgputegra.decoder import backend_for, make_decoder
    from ldpcgputegra.ops.layered import LayeredSpec

    code = load_code(name)
    spec = LayeredSpec(algo=algo, iters=iters, early_term=early_term)
    auto = backend_for(code, spec)
    qc = ["pallas", "xla"] if _is_qc(code, spec) else []
    backends = list(backends) or list(dict.fromkeys([auto] + qc))
    llr = channel_llrs(code, batch, ebn0_db, seed)
    x = jax.device_put(llr)
    compiled, compile_s = {}, {}
    for b in backends:
        dec = make_decoder(code, spec, backend=b, interpret=interpret)
        t0 = time.perf_counter()
        compiled[b] = dec.lower(x).compile()
        compile_s[b] = time.perf_counter() - t0
    # windows of three calls each, the backends alternating
    sec = measure_call(compiled, [x] * 3, windows=windows)
    ms = {b: t * 1e3 for b, t in sec.items()}
    n = batch if early_term else min(n_check, batch)
    ref_bits, ref_iters = golden(code, llr[:n], spec)
    want_iters = int(ref_iters.max())
    checks = {}
    for b, f in compiled.items():
        bits, it = f(x)
        bits = np.asarray(bits[:n])
        checks[b] = {
            "bits_equal": bool(np.array_equal(bits, ref_bits)),
            "iters": int(it),
            "iters_equal": int(it) == want_iters,
        }
    ok = all(c["bits_equal"] and c["iters_equal"] for c in checks.values())
    return {
        "phase": f"decode {name}", "ok": ok, "algo": algo, "iters": iters,
        "early_term": early_term, "batch": batch, "ebn0_db": ebn0_db,
        "auto": auto, "frames_checked": n, "golden_iters": want_iters,
        "checks": checks,
        "ms_per_call": ms,
        "coded_mbps": {b: batch * code.N / (t * 1e3) for b, t in ms.items()},
        "compile_s": compile_s,
        "peak_bytes_in_use": _peak_bytes(),
    }


def _is_qc(code, spec) -> bool:
    from ldpcgputegra.decoder import effective_code
    from ldpcgputegra.kernels import pallas_supported

    return pallas_supported(effective_code(code), spec)


def sweep_phase(name: str = "1944x972", snr: float = 2.0, fer: int = 100,
                batch: int = 4096, seed: int = 1234) -> dict:
    """One SNR point of ``run_sweep`` on the default device and on the host
    CPU (XLA path), same seed: the two frame error rates must agree within
    3 sigma."""
    import jax

    from ldpcgputegra.sim.sweep import SweepConfig, run_sweep

    cfg = SweepConfig(code=name, snr_min=snr, snr_max=snr, max_fe=fer,
                      batch=batch, seed=seed)
    t0 = time.perf_counter()
    dev = run_sweep(cfg, progress=False).points[0]
    dev_s = time.perf_counter() - t0
    with jax.default_device(jax.devices("cpu")[0]):
        t0 = time.perf_counter()
        cpu = run_sweep(dataclasses.replace(cfg, backend="xla"),
                        progress=False).points[0]
        cpu_s = time.perf_counter() - t0
    p = (dev.fe + cpu.fe) / (dev.frames + cpu.frames)
    sd = math.sqrt(max(p * (1 - p), 1e-300)
                   * (1 / dev.frames + 1 / cpu.frames))
    diff = abs(dev.fer - cpu.fer)
    return {
        "phase": f"sweep {name} {snr} dB", "ok": diff <= 3 * sd,
        "device": dataclasses.asdict(dev), "cpu": dataclasses.asdict(cpu),
        "fer_diff": diff, "three_sigma": 3 * sd,
        "device_s": dev_s, "cpu_s": cpu_s,
        "peak_bytes_in_use": _peak_bytes(),
    }


def twophase_phase(name: str = "1944x972", batch: int = 8192,
                   k1: int = 5, iters: int = 10, ebn0_db: float = 2.0,
                   seed: int = 1) -> dict:
    """One two-phase early-termination decode.  Frames whose ``k1``-iteration
    bits already satisfy every check must return the oracle's ``k1`` bits;
    the others the oracle's full-budget bits.  Also checks the one-hot
    tail gather against ``jnp.take`` on this batch."""
    import jax
    import jax.numpy as jnp

    from ldpcgputegra.codes.registry import load_code
    from ldpcgputegra.decoder.twophase import (
        make_twophase_decoder, onehot_gather,
    )
    from ldpcgputegra.golden import syndrome_ok
    from ldpcgputegra.ops.layered import LayeredSpec

    code = load_code(name)
    spec = LayeredSpec(algo="OMS", iters=iters)
    llr = channel_llrs(code, batch, ebn0_db, seed)
    x = jax.device_put(llr)
    dec = make_twophase_decoder(code, spec, k1=k1)
    t0 = time.perf_counter()
    bits, stats = dec(x)
    bits = np.asarray(bits)
    first_s = time.perf_counter() - t0
    short = dataclasses.replace(spec, iters=k1)
    b1, _ = golden(code, llr, short)
    b2, _ = golden(code, llr, spec)
    ok1 = np.array([syndrome_ok(code, b) for b in b1])
    want = np.where(ok1[:, None], b1, b2)
    idx = jnp.asarray(np.flatnonzero(~ok1)[: max(1, int((~ok1).sum()))],
                      jnp.int32)
    gat_ok = bool(jnp.array_equal(onehot_gather(x, idx), jnp.take(x, idx,
                                                                  axis=0)))
    bits_ok = bool(np.array_equal(bits, want))
    return {
        "phase": f"twophase {name}", "ok": bits_ok and gat_ok,
        "bits_equal": bits_ok, "gather_equal": gat_ok, "stats": stats,
        "first_call_s": first_s, "peak_bytes_in_use": _peak_bytes(),
    }


def four_card_phase(name: str = "64800x32400-dvbs2", batch: int = 1024,
                    tp_batch: int = 4, iters: int = 10,
                    ebn0_db: float = 1.0, windows: int = 5) -> dict:
    """The multi-card path on four devices of one process: a data-parallel
    decode over 4 cards, ``make_dp_tp_decoder`` on a 2x2 mesh and a tp=4
    row-sharded decode of single codewords, each bit-exact against the
    one-card decode of the same frames.  The three first calls run in
    threads so that their compilations overlap.  Then each step and the
    one-card decode are timed in alternating windows on inputs already
    placed the way each step shards them."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ldpcgputegra.bench import measure_call
    from ldpcgputegra.codes.registry import load_code
    from ldpcgputegra.decoder import make_decoder
    from ldpcgputegra.ops.layered import LayeredSpec
    from ldpcgputegra.parallel.mesh import (
        BATCH_AXIS, decode_mesh, decode_mesh_2d,
    )
    from ldpcgputegra.parallel.rowshard import (
        make_dp_tp_decoder, make_rowsharded_decoder,
    )
    from ldpcgputegra.parallel.sharded import make_sharded_decoder

    assert len(jax.devices()) >= 4, f"need 4 devices, have {jax.devices()}"
    code = load_code(name)
    spec = LayeredSpec(algo="OMS", iters=iters)
    llr = channel_llrs(code, batch, ebn0_db, seed=7)
    one = make_decoder(code, spec)
    x_one = jax.device_put(llr, jax.devices()[0])
    ref_bits = np.asarray(one(x_one)[0])
    m4, m22 = decode_mesh(4), decode_mesh_2d(2, 2)
    by_batch = P(BATCH_AXIS, None)
    runs = {
        "dp4": (make_sharded_decoder(code, spec, m4),
                jax.device_put(llr, NamedSharding(m4, by_batch))),
        "dp2xtp2": (make_dp_tp_decoder(code, spec, m22),
                    jax.device_put(llr[: batch // 8],
                                   NamedSharding(m22, by_batch))),
        "tp4": (make_rowsharded_decoder(code, spec, m4),
                jax.device_put(llr[:tp_batch], NamedSharding(m4, P()))),
    }

    def first(k):
        step, x = runs[k]
        t0 = time.perf_counter()
        jax.block_until_ready(step(x))
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(runs)) as pool:
        first_s = dict(zip(runs, pool.map(first, runs)))
    fns = {"one": one, **{k: step for k, (step, _) in runs.items()}}
    xs = {"one": [x_one] * 3, **{k: [x] * 3 for k, (_, x) in runs.items()}}
    sec = measure_call(fns, xs, windows=windows)
    res = {"phase": f"four cards {name}", "batch": batch,
           "devices": len(jax.devices()),
           "one_card": {"frames": batch, "ms": sec["one"] * 1e3}}
    ok = True
    for k, (step, x) in runs.items():
        out = step(x)
        n = x.shape[0]
        eq = bool(np.array_equal(np.asarray(out[0]), ref_bits[:n]))
        it_eq = int(out[1]) == iters
        ok &= eq and it_eq
        res[k] = {"frames": n, "bits_equal": eq, "iters": int(out[1]),
                  "iters_equal": it_eq, "first_call_s": first_s[k],
                  "ms": sec[k] * 1e3}
    res["ok"] = ok
    return res


ONE_CARD_PHASES = (
    ("2304x1152", dict(batch=8192)),
    ("1944x972", dict(batch=8192)),
    ("1944x972", dict(batch=8192, early_term=True)),
    ("64800x32400-dvbs2", dict(batch=1024, ebn0_db=1.0)),
    ("64800x21600", dict(batch=256, ebn0_db=0.8)),
    ("4000x2000", dict(batch=8192)),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card path and its 1-card reference")
    args = ap.parse_args(argv)
    try:
        import jax

        from ldpcgputegra.utils import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: the package is not importable here: {e}",
              file=sys.stderr)
        return 2
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU visible to JAX (devices: {devs})",
              file=sys.stderr)
        return 1
    from ldpcgputegra.golden.native import native_available

    if not native_available():
        print("chip_smoke: the native golden oracle did not build "
              "(make -C ldpcgputegra/native); the NumPy oracle is too slow "
              "for these batch sizes", file=sys.stderr)
        return 1
    card = card_line()
    print(f"chip_smoke: cache {enable_compile_cache()}", flush=True)
    if args.four_cards:
        phases = [lambda: four_card_phase()]
    else:
        phases = [lambda n=n, kw=kw: decode_phase(n, **kw)
                  for n, kw in ONE_CARD_PHASES]
        phases += [sweep_phase, twophase_phase]
    for run in phases:
        res = run()
        print(json.dumps(res), flush=True)
        if not res["ok"]:
            print(f"chip_smoke: phase failed: {res['phase']}",
                  file=sys.stderr)
            return 1
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
