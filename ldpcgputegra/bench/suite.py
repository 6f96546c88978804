"""Benchmark suite: decode throughput and latency across codes.

Covers the reference's measurement surface (M4): per-config coded Mbps at
5 and 10 iterations (the paper's two operating points), decode-only timing
with device-resident inputs, the roofline share against the card's
published peaks, and minimum-batch latency.  Writes
``benchmarks/RESULTS.md``.  Needs a GPU: a measurement never falls back to
the CPU.

Run:  python -m ldpcgputegra.bench.suite [--quick]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import jax

from ..channel.awgn import AwgnChannel, ChannelSpec
from ..codes.registry import load_code
from ..decoder import backend_for, effective_code, make_decoder
from ..ops.layered import LayeredSpec
from ..utils import enable_compile_cache
from .harness import measure_call, throughput_report
from .roofline import roofline_report

# (code, batch, {iters: published baseline Mbps [best device, 3 streams]})
# 10-iter: paper/ldpcGpuTegra.tex:337,345,353 (GTX 680); 5-iter: :338,346,354
CONFIGS = [
    ("576x288", 16384, {10: 127.0, 5: 217.0}),
    ("2304x1152", 8192, {10: 132.0, 5: 226.0}),
    ("1944x972", 8192, {}),
    ("2048x384", 8192, {}),   # deg-32 CN: highest per-check register pressure
    ("4000x2000", 4096, {10: 131.0, 5: 230.0}),
    ("4896x2448", 4096, {}),
    ("8000x4000", 2048, {10: 33.0}),  # TK1 heterogeneous, tex:318
    ("9972x4986", 2048, {}),
    ("16200x7560", 1024, {}),
    ("20000x10000", 1024, {}),
    ("64800x32400", 512, {}),
    # rate 2/3: the sub-pass-split schedule (repeated block-columns)
    ("64800x21600", 512, {}),
    # ---- registry tail: 10-iter only to bound suite time ----
    ("155x93", 16384, {}, (10,)),   # smallest QC code; odd Z=31
    ("200x100", 16384, {}, (10,)),
    ("816x408", 8192, {}, (10,)),
    ("1024x518", 8192, {}, (10,)),
    # the reference's compile-time DEFAULT code (matrix/code.h:1)
    ("1200x600", 8192, {}, (10,)),
    ("1248x624", 8192, {}, (10,)),
    ("2640x1320", 4096, {}, (10,)),
    ("802_11e_576x288", 16384, {}, (10,)),
    ("802_11e_1920x960", 8192, {}, (10,)),
    ("802_11e_2304x1152", 8192, {}, (10,)),
    ("802_11n-1944x972", 8192, {}, (10,)),
    ("16200x10800", 512, {}, (10,)),
    ("64800x32400-dvbs2", 256, {}, (10,)),
    # DVB-S2 rate extremes (9/10 and 8/9)
    ("64800x6480-dvbs2", 256, {}, (10,)),
    ("64800x7200-dvbs2", 256, {}, (10,)),
]

LAT_CONFIGS = ["576x288", "1944x972", "4000x2000", "64800x32400"]


def _inputs(code, batch: int, n: int, seed0: int = 0):
    chan = AwgnChannel(code.N, code.K, ChannelSpec())
    chan.configure(2.5)
    return [chan.generate_zero_int8(jax.random.key(seed0 + i), batch)
            for i in range(n)]


def bench_one(name: str, batch: int, iters: int, quick: bool) -> dict:
    """One suite row: decode-only time of the ``auto`` backend."""
    code = load_code(name)
    spec = LayeredSpec(algo="OMS", iters=iters, early_term=False)
    dec = make_decoder(code, spec)
    sec = measure_call(dec, _inputs(code, batch, 2 if quick else 4),
                       windows=3 if quick else 5)
    rep = throughput_report(sec, batch, code.N)
    roof = roofline_report(effective_code(code), spec, batch, sec)
    return {
        "code": name,
        "backend": backend_for(code, spec),
        "iters": iters,
        "batch": batch,
        **{k: round(v, 3) for k, v in rep.items()},
        "roofline_frac": round(roof["roofline_frac"], 3),
        "bound": roof["bound"],
    }


def bench_latency(name: str, iters: int, quick: bool) -> dict:
    """Minimum-batch (128 frames) decode latency — the reference's latency
    axis (``code/ldpc_decoder_arm/main.cpp:612-625`` reports per-frame
    latency alongside Mbps)."""
    code = load_code(name)
    spec = LayeredSpec(algo="OMS", iters=iters, early_term=False)
    dec = make_decoder(code, spec)
    batch = 128
    sec = measure_call(dec, _inputs(code, batch, 2 if quick else 4, 1000),
                       windows=3 if quick else 5)
    return {
        "code": name,
        "backend": backend_for(code, spec),
        "iters": iters,
        "batch": batch,
        "ms_per_call": round(sec * 1e3, 3),
        "us_per_frame": round(sec / batch * 1e6, 2),
        "coded_mbps": round(batch * code.N / sec / 1e6, 1),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="benchmarks/RESULTS.md")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"(EE) no GPU visible to JAX ({jax.devices()})")
    enable_compile_cache()

    rows, lat_rows = [], []
    for ent in CONFIGS:
        name, batch, baselines = ent[:3]
        for iters in (ent[3] if len(ent) > 3 else (10, 5)):
            t0 = time.time()
            r = bench_one(name, batch, iters, args.quick)
            base = baselines.get(iters)
            r["baseline_mbps"] = base
            if base:
                r["vs_baseline"] = round(r["coded_mbps"] / base, 1)
            rows.append(r)
            print(
                f"(PERF) {name} {iters}it [{r['backend']}]: "
                f"{r['ms_per_call']} ms, {r['coded_mbps']} Mbps coded, "
                f"roofline {r['roofline_frac']} ({r['bound']}-bound) "
                f"[{time.time()-t0:.0f}s]",
                flush=True,
            )
    for name in LAT_CONFIGS:
        r = bench_latency(name, 10, args.quick)
        lat_rows.append(r)
        print(
            f"(PERF) latency {name} [{r['backend']}]: {r['ms_per_call']} ms "
            f"/128-frame call, {r['us_per_frame']} us/frame",
            flush=True,
        )

    stamp = {"measured": time.strftime("%Y-%m-%d"),
             "device_kind": dev.device_kind}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("# Benchmark results (one card)\n\n")
        f.write(f"Measured {stamp['measured']} on {dev.device_kind}; "
                "coded-bit throughput, OMS, reference accounting "
                "(`main.cpp:311-315`).\n\n")
        f.write("| code | backend | iters | batch | ms/call | Mbps coded "
                "| roofline | vs best GPU baseline |\n")
        f.write("|---|---|---|---|---|---|---|---|\n")
        for r in rows:
            vs = (f"{r['vs_baseline']}x (vs {r['baseline_mbps']})"
                  if r.get("vs_baseline") else "—")
            f.write(
                f"| {r['code']} | {r['backend']} | {r['iters']} "
                f"| {r['batch']} | {r['ms_per_call']} | {r['coded_mbps']} "
                f"| {r['roofline_frac']} ({r['bound']}) | {vs} |\n"
            )
        f.write("\nMinimum-batch latency (128 frames, 10 iters):\n\n")
        f.write("| code | backend | ms / call | us/frame "
                "| Mbps at this batch |\n")
        f.write("|---|---|---|---|---|\n")
        for r in lat_rows:
            f.write(
                f"| {r['code']} | {r['backend']} | {r['ms_per_call']} "
                f"| {r['us_per_frame']} | {r['coded_mbps']} |\n"
            )
        f.write("\nRaw records:\n\n```json\n")
        for r in rows:
            f.write(json.dumps({**r, **stamp}) + "\n")
        for r in lat_rows:
            f.write(json.dumps({"latency": True, **r, **stamp}) + "\n")
        f.write("```\n")
    print(f"(II) wrote {args.out}")


if __name__ == "__main__":
    main()
