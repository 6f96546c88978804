#!/usr/bin/env python3
"""Extract QC-LDPC code definitions from reference-style C headers.

The reference (boiseHPSim/ldpcGpuTegra) ships each parity-check matrix as a
generated C header pair: ``constantes_gpu.h`` (N/K/M + degree classes) and
``constantes_decoder.h`` (flat ``PosNoeudsVariable`` edge table); x86/ARM
variants use ``constantes_sse.h`` with both in one file.  This tool parses
those tables and re-encodes them in this framework's own compact format:

* QC codes -> tiny JSON base-matrix files (block columns + cyclic shifts per
  block-row) — typically a few hundred numbers instead of 10^5 indices;
* non-QC remainders/codes -> .npz edge tables.

Usage:
    python tools/import_reference_matrices.py --src /root/reference \
        --out ldpcgputegra/codes/data

Also imports DVB-S2 encoder tables (EncValues) when present.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ldpcgputegra.codes.code import LdpcCode  # noqa: E402

_DEFINE = re.compile(r"#define\s+(\w+)\s+\(?(-?\d+)")
# encoder tables declare constants as ``int NAME = value;`` instead
_INT_CONST = re.compile(r"\bint\s+(\w+)\s*=\s*(-?\d+)\s*;")


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    return text


def _parse_array(text: str, name: str) -> np.ndarray | None:
    m = re.search(name + r"\s*\[[^\]]*\]\s*=\s*\{", text)
    if not m:
        return None
    start = text.index("{", m.start())
    end = text.index("}", start)
    body = text[start + 1 : end]
    vals = [int(v) for v in re.findall(r"-?\d+", body)]
    return np.asarray(vals, dtype=np.int64)


def parse_matrix_dir(path: str, name: str) -> LdpcCode | None:
    """Parse one reference matrix directory (gpu format) or sse header."""
    defines: dict[str, int] = {}
    table = None
    for fn in sorted(os.listdir(path)):
        if not fn.endswith(".h"):
            continue
        raw = open(os.path.join(path, fn), errors="replace").read()
        text = _strip_comments(raw)
        for dm in _DEFINE.finditer(text):
            defines.setdefault(dm.group(1), int(dm.group(2)))
        if table is None:
            table = _parse_array(text, "PosNoeudsVariable")
    req = ("_N", "_K", "_M", "DEG_1", "DEG_1_COMPUTATIONS")
    if table is None or any(k not in defines for k in req):
        return None
    classes = [(defines["DEG_1"], defines["DEG_1_COMPUTATIONS"])]
    if defines.get("NB_DEGRES", 1) > 1 and "DEG_2" in defines:
        classes.append((defines["DEG_2"], defines["DEG_2_COMPUTATIONS"]))
    M = defines["_M"]
    if table.size != M:
        print(f"  !! {name}: table size {table.size} != _M {M}; skipping")
        return None
    code = LdpcCode.from_edges(
        name, defines["_N"], defines["_K"], classes, table
    )
    code.check_valid()
    return code


def parse_encoder_table(path: str) -> dict | None:
    """Parse GenericEncoderTable.h (DVB-S2-style accumulate positions)."""
    raw = open(path, errors="replace").read()
    text = _strip_comments(raw)
    defines = {m.group(1): int(m.group(2)) for m in _DEFINE.finditer(text)}
    for m in _INT_CONST.finditer(text):
        defines.setdefault(m.group(1), int(m.group(2)))
    arr = _parse_array(text, r"EncValues")
    if arr is None or "N_LINES" not in defines:
        return None
    rows = []
    p = 0
    for _ in range(defines["N_LINES"]):
        nb = int(arr[p])
        p += 1
        rows.append(arr[p : p + nb].tolist())
        p += nb
    return {
        "N": defines.get("N_LDPC"),
        "K": defines.get("K_LDPC"),
        "M": defines.get("M_LDPC"),
        "Q": defines.get("Q_LDPC"),
        "rows": rows,
    }


def export_code(code: LdpcCode, out_dir: str) -> str:
    base = os.path.join(out_dir, code.name)
    if code.is_qc:
        doc = {
            "format": "qc-base-v1",
            "name": code.name,
            "N": code.N,
            "K": code.K,
            "Z": code.Z,
            "classes": [[c.deg, c.count] for c in code.classes],
            "rows": [
                {"cols": l.qc.cols.tolist(), "shifts": l.qc.shifts.tolist()}
                for l in code.layers
            ],
        }
        fn = base + ".json"
        with open(fn, "w") as f:
            json.dump(doc, f)
        return fn
    # mixed/non-QC: keep compact QC rows where detected + raw remainder
    qc_rows = []
    raw_layers = []
    for l in code.layers:
        if l.qc is not None:
            qc_rows.append((l.qc.cols, l.qc.shifts, l.deg))
        else:
            raw_layers.append(l.idx)
    fn = base + ".npz"
    np.savez_compressed(
        fn,
        N=code.N,
        K=code.K,
        Z=code.Z if code.Z else 0,
        classes=np.asarray([[c.deg, c.count] for c in code.classes]),
        edges=code.edges,
    )
    return fn


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="/root/reference")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "..", "ldpcgputegra", "codes", "data"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    seen: set[str] = set()
    roots = [
        os.path.join(args.src, "code/gpu_fixed/matrix"),
        os.path.join(args.src, "code/x86/Constantes"),
        os.path.join(args.src, "code/ldpc_decoder_arm/Constantes"),
        os.path.join(args.src, "code/ldpc_decoder_arm/cuda/matrix"),
    ]
    for root in roots:
        if not os.path.isdir(root):
            continue
        for d in sorted(os.listdir(root)):
            full = os.path.join(root, d)
            if not os.path.isdir(full):
                continue
            name = d.replace(".dvb-s2", "-dvbs2").replace(".", "_")
            if name in seen:
                continue
            try:
                code = parse_matrix_dir(full, name)
            except Exception as e:  # noqa: BLE001
                print(f"  !! {d}: {e}")
                continue
            if code is None:
                print(f"  -- {d}: no parsable table")
                continue
            fn = export_code(code, args.out)
            seen.add(name)
            nqc = sum(1 for l in code.layers if l.qc is not None)
            print(
                f"  ok {name}: N={code.N} K={code.K} M={code.M} Z={code.Z} "
                f"layers={len(code.layers)} (qc {nqc}) -> {os.path.basename(fn)}"
            )

    enc = os.path.join(args.src, "code/x86/CEncoder/GenericEncoderTable.h")
    if os.path.exists(enc):
        tab = parse_encoder_table(enc)
        if tab:
            fn = os.path.join(args.out, f"encoder_{tab['N']}x{tab['K']}.json")
            with open(fn, "w") as f:
                json.dump(tab, f)
            print(f"  ok encoder table N={tab['N']} K={tab['K']} -> {os.path.basename(fn)}")


if __name__ == "__main__":
    main()
