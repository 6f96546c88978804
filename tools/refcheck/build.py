"""Build the reference scalar-OMS oracle binary (see driver.cpp).

Compiles the UNMODIFIED reference sources from /root/reference for a chosen
LDPC code.  Code selection works by pre-including the per-code
``constantes_sse.h`` (``-include``): its ``CONSTANTES`` /
``_PosNoeudsVariable_`` guards make the reference's own hardwired selector
(``Constantes/constantes_sse.h`` -> 4000x2000) a no-op.

Reference sources compiled (all read-only, never copied into the repo):
  CDecoder/template/CDecoder.cpp            (base: fast_stop flag)
  CDecoder/template/CDecoder_fixed.cpp      (setVarRange/setMsgRange)
  CDecoder/template/CDecoder_fixed_x86.cpp  (var_nodes/var_mesgs buffers)
  CDecoder/OMS/CDecoder_OMS_fixed_x86.cpp   (the scalar OMS decode loop)
"""

from __future__ import annotations

import os
import shutil
import subprocess

REF_ARM = "/root/reference/code/ldpc_decoder_arm"

# registry code name -> reference constantes dir (ARM unsigned-short tables)
CODE_DIRS = {
    "576x288": "802.11e.576x288",
    "1944x972": "802.11n-1944x972",
    "4000x2000": "4000x2000",
    "8000x4000": "8000x4000",
    "2640x1320": "2640x1320",
}

_SOURCES = [
    "CDecoder/template/CDecoder.cpp",
    "CDecoder/template/CDecoder_fixed.cpp",
    "CDecoder/template/CDecoder_fixed_x86.cpp",
    "CDecoder/OMS/CDecoder_OMS_fixed_x86.cpp",
]


def compiler_available() -> bool:
    return shutil.which("g++") is not None


def reference_available() -> bool:
    return os.path.isdir(REF_ARM)


def build_oracle(code_name: str, workdir: str) -> str:
    """Compile the reference oracle for ``code_name``; returns binary path."""
    const_dir = os.path.join(REF_ARM, "Constantes", CODE_DIRS[code_name])
    select_h = os.path.join(const_dir, "constantes_sse.h")
    if not os.path.exists(select_h):
        raise FileNotFoundError(select_h)
    os.makedirs(workdir, exist_ok=True)
    # Fallback include dir: CDecoder_fixed_x86.cpp includes
    # "./Constantes/constantes_sse.h", which does not exist next to it;
    # provide it on the -I path (its content is guard-neutralized anyway).
    fb = os.path.join(workdir, "Constantes")
    os.makedirs(fb, exist_ok=True)
    with open(os.path.join(fb, "constantes_sse.h"), "w") as f:
        f.write(f'#include "{select_h}"\n')

    objs = []
    base_flags = [
        "g++", "-O2", "-w",
        "-include", select_h,
        "-I", workdir,
        "-I", os.path.join(REF_ARM, "CDecoder"),
    ]
    for src in _SOURCES:
        obj = os.path.join(workdir, os.path.basename(src) + ".o")
        subprocess.run(
            base_flags + ["-c", os.path.join(REF_ARM, src), "-o", obj],
            check=True, capture_output=True,
        )
        objs.append(obj)
    drv = os.path.join(os.path.dirname(__file__), "driver.cpp")
    obj = os.path.join(workdir, "driver.o")
    subprocess.run(
        base_flags + ["-c", drv, "-o", obj], check=True, capture_output=True
    )
    objs.append(obj)
    binary = os.path.join(workdir, f"ref_oms_{code_name}")
    subprocess.run(["g++", "-o", binary] + objs, check=True,
                   capture_output=True)
    return binary


def run_oracle(binary: str, llr, iters: int, offset: int, early: bool,
               sat_var: int = 127, sat_msg: int = 31):
    """Run the reference binary on an int8 LLR batch [B, N] -> bits [B, N]."""
    import numpy as np

    llr = np.asarray(llr, np.int8)
    b, n = llr.shape
    p = subprocess.run(
        [binary, str(b), str(iters), str(offset), str(int(early)),
         str(sat_var), str(sat_msg)],
        input=llr.tobytes(), capture_output=True, check=True,
    )
    return np.frombuffer(p.stdout, np.int8).reshape(b, n).copy()


REF_X86 = "/root/reference/code/x86"

# registry code name -> x86 constantes dir (these tables can differ from
# BOTH the gpu_fixed registry imports and the ARM tree)
X86_CODE_DIRS = {
    "576x288": "576x288",
    "1944x972": "1944x972",
    "2304x1152": "2304x1152",
}

_SOURCES_NMS_SSE = [
    "CDecoder/template/CDecoder.cpp",
    "CDecoder/template/CDecoder_fixed.cpp",
    "CDecoder/template/CDecoder_fixed_SSE.cpp",
    "CDecoder/NMS/CDecoder_NMS_fixed_SSE.cpp",
    "CTools/CTools.cpp",
]


def build_nms_sse_oracle(code_name: str, workdir: str,
                         opt: bool = False) -> str:
    """Compile the reference's SSE fixed-point NMS decoder UNMODIFIED for
    ``code_name``; returns the binary path.  Same pre-include selection
    trick as ``build_oracle`` but against the x86 tree.  ``opt=True``
    uses the reference's own CMake flags (-O3 -march=native)."""
    const_dir = os.path.join(REF_X86, "Constantes", X86_CODE_DIRS[code_name])
    select_h = os.path.join(const_dir, "constantes_sse.h")
    if not os.path.exists(select_h):
        raise FileNotFoundError(select_h)
    os.makedirs(workdir, exist_ok=True)
    fb = os.path.join(workdir, "Constantes")
    os.makedirs(fb, exist_ok=True)
    with open(os.path.join(fb, "constantes_sse.h"), "w") as f:
        f.write(f'#include "{select_h}"\n')

    objs = []
    base_flags = [
        "g++", "-w", "-msse4.2",
        *(("-O3", "-march=native") if opt else ("-O2",)),
        "-include", select_h,
        "-I", workdir,
        "-I", os.path.join(REF_X86, "CDecoder"),
    ]
    for src in _SOURCES_NMS_SSE:
        obj = os.path.join(workdir, os.path.basename(src) + ".sse.o")
        subprocess.run(
            base_flags + ["-c", os.path.join(REF_X86, src), "-o", obj],
            check=True, capture_output=True,
        )
        objs.append(obj)
    drv = os.path.join(os.path.dirname(__file__), "driver_nms_sse.cpp")
    obj = os.path.join(workdir, "driver_nms_sse.o")
    subprocess.run(
        base_flags + ["-c", drv, "-o", obj], check=True, capture_output=True
    )
    objs.append(obj)
    binary = os.path.join(workdir, f"ref_nms_sse_{code_name}")
    subprocess.run(["g++", "-o", binary] + objs, check=True,
                   capture_output=True)
    return binary


_SOURCES_OMS_SSE = [
    "CDecoder/template/CDecoder.cpp",
    "CDecoder/template/CDecoder_fixed.cpp",
    "CDecoder/template/CDecoder_fixed_SSE.cpp",
    "CDecoder/OMS/CDecoder_OMS_fixed_SSE.cpp",
    "CTools/CTools.cpp",
]


def build_oms_sse_oracle(code_name: str, workdir: str,
                         opt: bool = False) -> str:
    """Compile the reference's SSE fixed-point OMS decoder UNMODIFIED.
    ``opt=True`` uses the reference's own CMake flags (-O3 -march=native,
    CMakeLists.txt:10) — for head-to-head benching, not vector checks."""
    const_dir = os.path.join(REF_X86, "Constantes", X86_CODE_DIRS[code_name])
    select_h = os.path.join(const_dir, "constantes_sse.h")
    if not os.path.exists(select_h):
        raise FileNotFoundError(select_h)
    os.makedirs(workdir, exist_ok=True)
    fb = os.path.join(workdir, "Constantes")
    os.makedirs(fb, exist_ok=True)
    with open(os.path.join(fb, "constantes_sse.h"), "w") as f:
        f.write(f'#include "{select_h}"\n')

    objs = []
    base_flags = [
        "g++", "-w", "-msse4.2",
        *(("-O3", "-march=native") if opt else ("-O2",)),
        "-include", select_h,
        "-I", workdir,
        "-I", os.path.join(REF_X86, "CDecoder"),
    ]
    for src in _SOURCES_OMS_SSE:
        obj = os.path.join(workdir, os.path.basename(src) + ".omssse.o")
        subprocess.run(
            base_flags + ["-c", os.path.join(REF_X86, src), "-o", obj],
            check=True, capture_output=True,
        )
        objs.append(obj)
    drv = os.path.join(os.path.dirname(__file__), "driver_oms_sse.cpp")
    obj = os.path.join(workdir, "driver_oms_sse.o")
    subprocess.run(
        base_flags + ["-c", drv, "-o", obj], check=True, capture_output=True
    )
    objs.append(obj)
    binary = os.path.join(workdir, f"ref_oms_sse_{code_name}")
    subprocess.run(["g++", "-o", binary] + objs, check=True,
                   capture_output=True)
    return binary


def run_oms_sse_oracle(binary: str, llr, iters: int, offset: int,
                       sat_msg: int = 31):
    """Run the SSE OMS reference binary on [B, N] int8 LLRs -> bits."""
    import numpy as np

    llr = np.asarray(llr, np.int8)
    b, n = llr.shape
    p = subprocess.run(
        [binary, str(b), str(iters), str(offset), str(sat_msg)],
        input=llr.tobytes(), capture_output=True, check=True,
    )
    return np.frombuffer(p.stdout, np.int8).reshape(b, n).copy()


def run_nms_sse_oracle(binary: str, llr, iters: int, factor: int,
                       sat_var: int = 127, sat_msg: int = 31):
    """Run the SSE NMS reference binary on [B, N] int8 LLRs -> bits.
    B must be a multiple of 16 (the decoder packs 16 frames per vector)."""
    import numpy as np

    llr = np.asarray(llr, np.int8)
    b, n = llr.shape
    p = subprocess.run(
        [binary, str(b), str(iters), str(factor), str(sat_var),
         str(sat_msg)],
        input=llr.tobytes(), capture_output=True, check=True,
    )
    return np.frombuffer(p.stdout, np.int8).reshape(b, n).copy()


def parse_x86_table(code_name: str):
    """Parse the x86 constantes PosNoeudsVariable table -> flat VN indices."""
    import re

    import numpy as np

    path = os.path.join(
        REF_X86, "Constantes", X86_CODE_DIRS[code_name], "constantes_sse.h"
    )
    with open(path) as f:
        text = f.read()
    m = re.search(
        r"PosNoeudsVariable\s*\[\s*\d+\s*\]\s*=\s*\{(.*?)\}", text, re.S
    )
    body = re.sub(r"/\*.*?\*/", "", m.group(1), flags=re.S)
    return np.array(
        [int(t) for t in re.findall(r"-?\d+", body)], dtype=np.int64
    )


def parse_x86_code(code_name: str):
    """Build an LdpcCode from the x86 constantes header (macros + table)."""
    import re

    from ldpcgputegra.codes.code import LdpcCode

    path = os.path.join(
        REF_X86, "Constantes", X86_CODE_DIRS[code_name], "constantes_sse.h"
    )
    with open(path) as f:
        text = f.read()

    def macro(name):
        return int(re.search(rf"#define\s+{name}\s+(-?\d+)", text).group(1))

    n, ndeg = macro("_N"), macro("NB_DEGRES")
    classes = [
        (macro(f"DEG_{i}"), macro(f"DEG_{i}_COMPUTATIONS"))
        for i in range(1, ndeg + 1)
    ]
    edges = parse_x86_table(code_name)
    return LdpcCode.from_edges(
        f"x86-{code_name}", n, None, classes, edges, detect_qc=False
    )


def parse_arm_table(code_name: str):
    """Parse the ARM constantes PosNoeudsVariable table -> flat VN indices."""
    import re

    import numpy as np

    path = os.path.join(
        REF_ARM, "Constantes", CODE_DIRS[code_name], "constantes_sse.h"
    )
    with open(path) as f:
        text = f.read()
    m = re.search(
        r"PosNoeudsVariable\s*\[\s*\d+\s*\]\s*=\s*\{(.*?)\}", text, re.S
    )
    body = re.sub(r"/\*.*?\*/", "", m.group(1), flags=re.S)
    return np.array(
        [int(t) for t in re.findall(r"-?\d+", body)], dtype=np.int64
    )


def parse_arm_code(code_name: str):
    """Build an LdpcCode from the ARM constantes header (macros + table).

    The ARM tables can differ from the gpu_fixed ones already in the repo's
    registry (different row order / H instance for the same N x K), so the
    refcheck comparison decodes the code AS THE COMPILED REFERENCE SEES IT.
    """
    import re

    from ldpcgputegra.codes.code import LdpcCode

    path = os.path.join(
        REF_ARM, "Constantes", CODE_DIRS[code_name], "constantes_sse.h"
    )
    with open(path) as f:
        text = f.read()

    def macro(name):
        return int(re.search(rf"#define\s+{name}\s+(-?\d+)", text).group(1))

    n, ndeg = macro("_N"), macro("NB_DEGRES")
    classes = [
        (macro(f"DEG_{i}"), macro(f"DEG_{i}_COMPUTATIONS"))
        for i in range(1, ndeg + 1)
    ]
    edges = parse_arm_table(code_name)
    return LdpcCode.from_edges(
        f"arm-{code_name}", n, None, classes, edges, detect_qc=False
    )
