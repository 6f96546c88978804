#!/usr/bin/env python3
"""Re-measure selected waterfall points to a hard FE target and merge them
into the saved curve JSON (benchmarks/ber_data/<id>.json), then regenerate
BER.md.

Why this exists: the curve runner's original per-point wall budget
(``timer_s=90``) and the adaptive FE limit (``auto_fe``, the reference's
CErrorAnalyzer /2../16 shrink — ``code/ldpc_decoder_arm/CErrorAnalyzer/
CErrorAnalyzer.cpp``) both truncate deep-tail points at 8-28 frame errors,
a ~±40% sampling error.  This tool runs points with ``auto_fe=False`` and
no wall cap so the stated ``--max-fe`` is the real stopping rule
(``--max-frames`` remains the safety budget).

Usage:
  python tools/topup_points.py --curve 1944x972_OMS_10 --snr 2.5 --snr 2.75 \
      --max-fe 100 --max-frames 40000000 --batch 8192
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ldpcgputegra.sim.sweep import SweepConfig, run_sweep  # noqa: E402
from ldpcgputegra.utils import enable_compile_cache  # noqa: E402

from run_ber_curves import DATA_DIR, write_md  # noqa: E402


def merge_point(points: list[dict], rec: dict) -> bool:
    """Merge ``rec`` into the curve's point list, in place.

    A point at the same SNR is replaced only if ``rec`` saw at least as
    many frame errors (ties broken by frame count) — a truncated or
    interrupted re-run can never regress saved statistics.  Returns True
    if ``rec`` was inserted/replaced, False if the old point won.
    """
    for i, old in enumerate(points):
        if abs(old["snr_db"] - rec["snr_db"]) < 1e-9:
            if (rec["fe"], rec["frames"]) >= (old["fe"], old["frames"]):
                points[i] = rec
                points.sort(key=lambda r: r["snr_db"])
                return True
            return False
    points.append(rec)
    points.sort(key=lambda r: r["snr_db"])
    return True


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--curve", required=True,
                    help="curve id, e.g. 1944x972_OMS_10")
    ap.add_argument("--snr", action="append", type=float, required=True,
                    help="SNR point to re-measure (repeatable)")
    ap.add_argument("--max-fe", type=int, default=100)
    ap.add_argument("--max-frames", type=int, default=40_000_000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--backend", default="auto",
                    help="auto | xla | native (AVX-512 host decoder)")
    ap.add_argument("--channel-rng", default="threefry",
                    choices=["threefry", "philox"],
                    help="philox = native counter-based channel (~7x "
                    "faster; different stream, statistically identical — "
                    "mixing streams across batches of one point is sound: "
                    "both draw iid from the same channel law)")
    args = ap.parse_args()

    code, algo, iters = args.curve.rsplit("_", 2)

    enable_compile_cache()
    import jax

    backend = jax.default_backend()
    if args.backend == "native":
        backend = "native+" + args.channel_rng

    path = os.path.join(DATA_DIR, args.curve + ".json")
    with open(path) as f:
        data = json.load(f)

    for snr in args.snr:
        # per-point sweep checkpoint: a multi-hour deep-tail top-up
        # survives a kill/timeout and resumes mid-point
        ckpt_path = os.path.join(
            DATA_DIR, f"ckpt_topup_{args.curve}_{snr}.json"
        )
        cfg = SweepConfig(
            code=code,
            algo=algo,
            iters=int(iters),
            snr_min=snr,
            snr_max=snr,
            snr_step=1.0,
            batch=args.batch,
            max_fe=args.max_fe,
            auto_fe=False,
            max_frames=args.max_frames,
            early_term=True,
            checkpoint=ckpt_path,
            backend=args.backend,
            channel_rng=args.channel_rng,
        )
        res = run_sweep(cfg, progress=True)
        (p,) = res.points
        rec = {
            "snr_db": p.snr_db,
            "ber": p.ber,
            "fer": p.fer,
            "frames": p.frames,
            "fe": p.fe,
            "be": p.be,
            "backend": backend,
        }
        if not merge_point(data["points"], rec):
            print(f"(WW) keeping old point at {p.snr_db} dB "
                  f"(it saw more frame errors than this re-run)")
        with open(path, "w") as f:  # checkpoint after every point
            json.dump(data, f, indent=1)
        if os.path.exists(ckpt_path):  # point persisted; ckpt now moot
            os.remove(ckpt_path)
        print(f"(II) {p.snr_db} dB: BER {p.ber:.3e} on {p.fe} FE "
              f"/ {p.frames} frames", flush=True)
    print(f"wrote {write_md()}")


if __name__ == "__main__":
    main()
