#!/usr/bin/env python3
"""Produce BER/FER waterfall curves on the live backend -> benchmarks/BER.md.

The statistical oracle of SURVEY §4: a correct fixed-point layered decoder
must reproduce the expected waterfall.  Bit-exactness against the golden
oracles already pins the semantics; these curves document the channel
quality end-to-end (channel + quantizer + decoder + analyzer).

Each curve's points are persisted to ``benchmarks/ber_data/<id>.json`` as
they finish, and ``benchmarks/BER.md`` is regenerated from ALL saved
curves — so curves can be (re)run selectively with ``--only`` without
discarding previously measured ones.

Note on external validation: the reference's paper
(``paper/ldpcGpuTegra.tex``) publishes NO BER figures — it is throughput-
only — so there is no paper waterfall to diff against.  The external bar
used instead is the published literature waterfalls for these standard
codes (802.11n 1944x972, 802.16e 576x288/2304x1152); see the analysis
notes appended to BER.md.

Usage:  python tools/run_ber_curves.py [--only 576x288_2NMS_10,...]
                                       [--max-fe N] [--max-frames N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ldpcgputegra.sim.sweep import SweepConfig, run_sweep  # noqa: E402
from ldpcgputegra.utils import enable_compile_cache  # noqa: E402

# (code, algo, iters, snr_min, snr_max, snr_step, batch[, extra])
# extra: optional dict of additional SweepConfig fields; its "tag" key (if
# any) suffixes the curve id and the BER.md section title instead.
CURVES = [
    ("1944x972", "OMS", 10, 0.5, 2.75, 0.25, 8192),
    ("576x288", "OMS", 10, 0.5, 3.5, 0.5, 16384),
    ("2304x1152", "NMS", 10, 0.5, 2.5, 0.25, 8192),
    ("576x288", "2NMS", 10, 1.0, 3.5, 0.5, 16384),
    # range probed on CPU: at 10 iters the waterfall spans ~1.4-2.1 dB
    # (FER 1.0 at 1.25, 0.6 at 1.5, 0.04 at 1.75, 1e-3 at 2.0); fine
    # 0.125 dB steps resolve the steep long-code cliff
    ("64800x32400", "OMS", 10, 1.0, 2.0, 0.125, 512),
    # rate 2/3 DVB-S2: statistical validation of the sub-pass-split
    # schedule (repeated block-columns).  CPU probe: FER 1.0 at 2.0 dB,
    # 0.39 at 2.25, 2e-3 at 2.5
    ("64800x21600", "OMS", 10, 1.75, 2.625, 0.125, 512),
    # the paper's headline unstructured code (`paper/ldpcGpuTegra.tex:349`);
    # exercises the non-QC gather path end-to-end statistically.  Range
    # probed on CPU: FER 1.0 at 1.0 dB, 0.53 at 1.5, 3.4e-3 at 2.0
    ("4000x2000", "OMS", 10, 1.0, 2.5, 0.25, 4096),
    # 10GBASE-T-like rate-13/16 code: the registry's highest CN degree
    # (32) — statistical end-to-end validation of the high-degree CN
    # machinery (bit-exactness alone can't show the waterfall is right).
    # CPU probe: FER 0.62 at 3.5 dB, 2.4e-2 at 4.0, <1e-4 at 4.5
    ("2048x384", "OMS", 10, 3.25, 4.5, 0.25, 2048),
    # Rayleigh-fading channel (the reference parses -Rayleigh_Fading but
    # ships no implementation — `code/ldpc_decoder_arm/main.cpp:254-261`;
    # this framework has a real one, channel/awgn.py).  Perfect-CSI flat
    # fading.  CPU probe: FER 0.44 at 4 dB, 7.8e-3 at 6, <1e-4 at 8
    ("576x288", "OMS", 10, 3.0, 7.0, 0.5, 8192,
     {"fading": "rayleigh", "tag": "rayleigh"}),
    # the paper's SECOND operating point (5 iterations — every 5-iter
    # throughput row in RESULTS.md / the paper's tables) needs its own
    # BER anchor.  CPU probe: FER 0.32 at 2.0 dB, 9.0e-3 at 3.0, <1e-4
    # at 4.0
    ("576x288", "OMS", 5, 1.0, 4.0, 0.5, 16384),
    # the second non-QC gather-path code (TK1-heterogeneous baseline at
    # tex:318).  CPU probe: FER 0.98 at 1.25 dB, 0.56 at 1.5, 4.0e-2 at
    # 1.75, 2.0e-4 at 2.0
    ("8000x4000", "OMS", 10, 1.0, 2.25, 0.25, 2048),
    # the third (largest) non-QC code.  CPU probe: FER 0.96 at 1.25 dB,
    # 0.33 at 1.5, 4.5e-3 at 1.75, <1e-4 at 2.0
    ("9972x4986", "OMS", 10, 1.0, 2.0, 0.25, 2048),
    # DVB-T2 short FECFRAME (staircase QC view at Z=360, same machinery
    # as the 64800 family at 1/4 the block).  CPU probe: FER 1.0 at 1.2
    # dB, 0.20 at 1.6, 2.8e-4 at 2.0
    ("16200x7560", "OMS", 10, 1.0, 2.2, 0.2, 1024),
    # the two remaining suite-benched families (queue9).  4896x2448 CPU
    # probe: FER 0.97 at 1.2 dB, 0.29 at 1.6, 2e-3 at 2.0, <2e-4 at 2.4
    ("4896x2448", "OMS", 10, 1.2, 2.4, 0.2, 2048,
     {"backend": "native", "channel_rng": "philox"}),
    # 20000x10000 probe: FER 1.0 at 1.0 dB, 0.95 at 1.4, 2.3e-4 at 1.8 —
    # the steepest cliff in the registry (longest random-like block)
    ("20000x10000", "OMS", 10, 1.0, 2.0, 0.2, 512,
     {"backend": "native", "channel_rng": "philox"}),
    # ---- all-zero-codeword blind-spot closure (VERDICT r2 #4) ----
    # real random info bits through the imported DVB table encoder
    # (GenericEncoder semantics, `GenericEncoder.cpp:38-78`) with
    # info-bit counting (`CErrorAnalyzer.cpp:131`), overlaid on its
    # all-zero twin at the same counting — the two curves must coincide
    # within statistics.  CPU probe (coded): FER 0.91 at 2.0 dB,
    # 9.2e-3 at 2.4, <2e-4 at 2.8
    ("16200x10800", "OMS", 10, 1.8, 2.8, 0.2, 1024,
     {"tag": "zero-info", "count_bits": "info"}),
    ("16200x10800", "OMS", 10, 1.8, 2.8, 0.2, 1024,
     {"tag": "coded-info", "encoder": "table", "random_bits": True,
      "count_bits": "info"}),
    # QPSK with random GF(2)-encoded bits (`CChanelAWGN_x86.cpp:100-118`):
    # the reference's ±1/√2-per-dimension mapping at BPSK's sigma formula
    # puts the curve 3.01 dB right of BPSK, plus a small extra loss from
    # the FIXED factor-8 quantizer (effective LLR scale 8/√2) — verified
    # against the all-zero QPSK twin (coincide) and BPSK (shift+quantizer),
    # see BER_NOTES.md.  Grid = BPSK grid + 3.01 dB for direct overlay.
    ("576x288", "OMS", 10, 3.51, 6.51, 0.5, 16384,
     {"tag": "qpsk-coded", "qpsk": True, "encoder": "gf2",
      "random_bits": True, "backend": "native",
      "channel_rng": "philox"}),
]

BENCH_DIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks")
DATA_DIR = os.path.join(BENCH_DIR, "ber_data")


def curve_id(code: str, algo: str, iters: int, tag: str = "") -> str:
    base = f"{code}_{algo}_{iters}"
    return base + ("_" + tag if tag else "")


def run_curve(code, algo, iters, lo, hi, step, batch, max_fe, max_frames,
              timer_s=None, extra=None):
    extra = dict(extra or {})
    tag = extra.pop("tag", "")
    # Per-curve sweep checkpoint: multi-hour deep-tail curves survive a
    # kill/timeout and resume mid-point (sweep.py persists per-point
    # counters + the PRNG fold state after every batch window).  Deleted
    # once the curve lands in <id>.json.
    ckpt_path = os.path.join(
        DATA_DIR, "ckpt_" + curve_id(code, algo, iters, tag) + ".json"
    )
    cfg = SweepConfig(
        code=code,
        algo=algo,
        iters=iters,
        snr_min=lo,
        snr_max=hi,
        snr_step=step,
        batch=batch,
        max_fe=max_fe,
        max_frames=max_frames,
        timer_s=timer_s,
        early_term=True,
        checkpoint=ckpt_path,
        **extra,
    )
    print(f"== {code} {algo} {iters}it ==", flush=True)
    res = run_sweep(cfg, progress=True)
    # NOTE: the checkpoint is NOT deleted here — main() removes it only
    # after the final curve JSON has been written, so a kill between
    # sweep completion and persistence cannot lose the whole curve
    import jax

    return {
        "code": code,
        "algo": algo,
        "iters": iters,
        "tag": tag,
        # curves are backend-independent by construction (decoders are
        # bit-exact across backends — the native path is additionally
        # bit-checked per point; the channel is counter-based threefry or
        # philox, both deterministic) — recorded for provenance only
        "backend": (
            f"native+{cfg.channel_rng}" if cfg.backend == "native"
            else jax.default_backend()
        ),
        "points": [
            {
                "snr_db": p.snr_db,
                "ber": p.ber,
                "fer": p.fer,
                "frames": p.frames,
                "fe": p.fe,
                "be": p.be,
            }
            for p in res.points
        ],
    }


def write_md() -> str:
    out = os.path.join(BENCH_DIR, "BER.md")
    lines = [
        "# BER/FER waterfalls (fixed-point layered decoding)\n",
        "\nAWGN, BPSK, all-zero codeword, factor-8 int8 LLRs (+/-31), "
        "adaptive FE limit, early termination on — except where a "
        "curve's title says otherwise (the `coded` curves decode REAL "
        "random info bits through a real encoder, the `qpsk` curve uses "
        "the reference's QPSK mapping; these close the all-zero-codeword "
        "validation blind spot).  Curves are "
        "backend-independent by construction (all decode paths are "
        "bit-exact vs the golden oracles and each other; the channel is "
        "counter-based threefry), so curves measured on any backend agree "
        "within their statistics (the channel's float math may round "
        "differently per device); throughput is measured separately.\n",
        "\nThe reference paper (`paper/ldpcGpuTegra.tex`) publishes no BER "
        "figures (throughput only), so no paper waterfall exists to diff "
        "against; the curves below are checked against published "
        "literature waterfalls for the same standard codes instead.\n",
    ]
    curves = []
    if os.path.isdir(DATA_DIR):
        for fn in sorted(os.listdir(DATA_DIR)):
            if fn.endswith(".json") and not fn.startswith("ckpt_"):
                with open(os.path.join(DATA_DIR, fn)) as f:
                    curves.append(json.load(f))
    # keep the CURVES declaration order for known ids
    order = {}
    for k, ent in enumerate(CURVES):
        c, a, i = ent[0], ent[1], ent[2]
        tag = ent[7].get("tag", "") if len(ent) > 7 else ""
        order[curve_id(c, a, i, tag)] = k
    curves.sort(
        key=lambda d: order.get(
            curve_id(d["code"], d["algo"], d["iters"], d.get("tag", "")), 99
        )
    )
    for cur in curves:
        title = f"{cur['code']} — {cur['algo']}, {cur['iters']} iterations"
        tag_titles = {
            "rayleigh": ", Rayleigh fading (perfect CSI)",
            "zero-info": ", all-zero codeword, info-bit counting",
            "coded-info": ", RANDOM info bits via the DVB table encoder, "
                          "info-bit counting",
            "qpsk-coded": ", QPSK, random GF(2)-encoded bits "
                          "(grid = BPSK grid + 3.01 dB)",
        }
        if cur.get("tag") in tag_titles:
            title += tag_titles[cur["tag"]]
        elif cur.get("tag"):
            title += f", {cur['tag']}"
        lines.append(f"\n## {title}\n\n")
        lines.append("| Eb/N0 (dB) | BER | FER | frames | FE |\n")
        lines.append("|---|---|---|---|---|\n")
        for p in cur["points"]:
            lines.append(
                f"| {p['snr_db']:.2f} | {p['ber']:.3e} | {p['fer']:.3e} "
                f"| {p['frames']} | {p['fe']} |\n"
            )
    notes = os.path.join(BENCH_DIR, "BER_NOTES.md")
    if os.path.exists(notes):
        with open(notes) as f:
            lines.append("\n" + f.read())
    with open(out, "w") as f:
        f.writelines(lines)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="", help="comma-separated curve ids")
    ap.add_argument("--max-fe", type=int, default=100)
    ap.add_argument("--max-frames", type=int, default=3_000_000)
    ap.add_argument(
        "--timer-s", type=float, default=None,
        help="per-point wall budget (default none: FE/frame limits rule; "
        "the old hard-coded 90s truncated deep-tail points at <30 FE)",
    )
    ap.add_argument(
        "--md-only", action="store_true",
        help="regenerate BER.md from saved data, no decoding",
    )
    args = ap.parse_args()

    os.makedirs(DATA_DIR, exist_ok=True)
    if not args.md_only:
        enable_compile_cache()
        only = {s for s in args.only.split(",") if s}
        for ent in CURVES:
            code, algo, iters, lo, hi, step, batch = ent[:7]
            extra = ent[7] if len(ent) > 7 else {}
            cid = curve_id(code, algo, iters, extra.get("tag", ""))
            if only and cid not in only:
                continue
            data = run_curve(
                code, algo, iters, lo, hi, step, batch,
                args.max_fe, args.max_frames, args.timer_s, extra=extra,
            )
            with open(os.path.join(DATA_DIR, cid + ".json"), "w") as f:
                json.dump(data, f, indent=1)
            ckpt = os.path.join(DATA_DIR, "ckpt_" + cid + ".json")
            if os.path.exists(ckpt):  # results persisted; ckpt now moot
                os.remove(ckpt)
            write_md()  # checkpoint the document after every curve
    out = write_md()
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
