#!/usr/bin/env python3
"""One waterfall BER anchor point per registry-tail code (VERDICT r4 #4).

The registry imports every reference matrix, but a code that appears in
no BER curve has never been exercised END-TO-END statistically
("loadable is not done").  For each tail code this tool:

1. probes up a 0.5 dB ladder with small frame counts until the FER
   lands inside the waterfall (target band [0.02, 0.3] — one meaningful
   anchor, cheap to measure);
2. measures that single point to ``--max-fe`` frame errors (capped);
3. saves it as a 1-point curve (tag ``tail-anchor``) in
   ``benchmarks/ber_data`` and regenerates BER.md.

Curves are backend-independent (bit-exact decoders + counter-based
channel), so this runs on CPU — launch with ``JAX_PLATFORMS=cpu`` to
keep the GPU free.  The native AVX-512 engine is used where it
supports the code (everything non-staircase); staircase QC-view codes
fall back to the XLA path.

Usage: JAX_PLATFORMS=cpu python tools/tail_ber_points.py [--only a,b]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ldpcgputegra.sim.sweep import SweepConfig, run_sweep  # noqa: E402
from ldpcgputegra.utils import enable_compile_cache  # noqa: E402

# (name, batch, snr_start_db) — start below the expected waterfall and
# walk up; rate-matched rough starts (R=1/2 ~ 1.5-2 dB, high-rate DVB
# extremes much higher)
TAIL = [
    ("155x93", 4096, 2.5),
    ("200x100", 4096, 2.5),
    ("816x408", 4096, 1.5),
    ("1024x518", 4096, 1.5),
    ("1200x600", 4096, 1.5),
    ("1248x624", 4096, 1.5),
    ("2640x1320", 2048, 1.0),
    ("802_11e_576x288", 8192, 2.0),
    ("802_11e_1920x960", 4096, 1.5),
    ("802_11e_2304x1152", 4096, 1.5),
    ("802_11n-1944x972", 4096, 1.5),
    ("64800x32400-dvbs2", 256, 1.0),
    ("64800x7200-dvbs2", 256, 3.0),
    ("64800x6480-dvbs2", 256, 3.5),
]

DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "ber_data")


def _point(name, batch, snr, max_fe, max_frames, backend, ckpt=None):
    cfg = SweepConfig(
        code=name, algo="OMS", iters=10, early_term=True,
        snr_min=snr, snr_max=snr, snr_step=0.5, batch=batch,
        max_fe=max_fe, auto_fe=False, max_frames=max_frames,
        backend=backend,
        channel_rng="philox" if backend == "native" else "threefry",
        checkpoint=ckpt,
    )
    res = run_sweep(cfg, progress=False)
    return res.points[0]


def _backend_for(name: str) -> str:
    """native where the engine accepts the code, else auto (xla on CPU)."""
    try:
        p = _point(name, 128, 10.0, 1_000_000, 128, "native")
        del p
        return "native"
    except Exception as e:  # noqa: BLE001 - staircase QC views refuse
        print(f"(II) {name}: native engine unavailable "
              f"({type(e).__name__}); using xla", flush=True)
        return "auto"


def anchor(name: str, batch: int, snr0: float, max_fe: int,
           max_frames: int) -> dict | None:
    backend = _backend_for(name)
    snr = snr0
    probe_frames = 4 * batch
    chosen = None
    for _ in range(12):
        p = _point(name, batch, snr, 10**9, probe_frames, backend)
        print(f"(II) {name} probe {snr:.2f} dB: FER {p.fer:.3g} "
              f"({p.fe}/{p.frames})", flush=True)
        if p.fer <= 0.3:
            if p.fer >= 0.02 or p.fe >= 5:
                chosen = snr
            else:
                chosen = snr - 0.25  # overshot the cliff: step half back
            break
        snr += 0.5
    if chosen is None:
        print(f"(EE) {name}: no waterfall found in 6 dB above {snr0}",
              flush=True)
        return None
    cid = f"{name}_OMS_10_tail-anchor"
    ckpt = os.path.join(DATA_DIR, "ckpt_" + cid + ".json")
    p = _point(name, batch, chosen, max_fe, max_frames, backend, ckpt)
    rec = {
        "code": name, "algo": "OMS", "iters": 10, "tag": "tail-anchor",
        "backend": f"{backend}+philox" if backend == "native" else backend,
        "points": [{
            "snr_db": p.snr_db, "ber": p.ber, "fer": p.fer,
            "frames": p.frames, "fe": p.fe, "be": p.be,
        }],
    }
    with open(os.path.join(DATA_DIR, cid + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    if os.path.exists(ckpt):
        os.remove(ckpt)
    print(f"(PERF) {json.dumps(rec)}", flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="", help="comma-separated code names")
    ap.add_argument("--max-fe", type=int, default=100)
    ap.add_argument("--max-frames", type=int, default=500_000)
    args = ap.parse_args()
    enable_compile_cache()
    os.makedirs(DATA_DIR, exist_ok=True)
    only = {s for s in args.only.split(",") if s}
    for name, batch, snr0 in TAIL:
        if only and name not in only:
            continue
        cap = args.max_frames if "64800" not in name else 50_000
        try:
            anchor(name, batch, snr0, args.max_fe, cap)
        except Exception as e:  # noqa: BLE001
            print(f"(EE) {name}: {type(e).__name__}: {e}", flush=True)
    # regenerate the published document from ALL saved curves
    sys.argv = ["run_ber_curves.py", "--md-only"]
    import importlib

    rbc = importlib.import_module("run_ber_curves")
    rbc.write_md()
    print("(II) BER.md regenerated")


if __name__ == "__main__":
    main()
