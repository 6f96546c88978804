"""Roofline accounting for the decoders.

The layered min-sum decoder does no matrix products: its ceilings are the
card's 32-bit integer ALU rate and its device-memory bandwidth.  The op
and byte counts are a model computed from the code's shape
(``ops_per_edge``, ``kernel_model``); the peaks come from one table keyed
by ``jax.Device.device_kind``, with their source.  A device that is not in
the table is an error, never a default.
"""

from __future__ import annotations

import dataclasses

from ..codes.code import LdpcCode
from ..ops.layered import LayeredSpec

__all__ = [
    "DeviceSpec", "PEAKS", "device_spec", "ops_per_edge", "kernel_model",
    "roofline_report",
]


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    int32_ops: float  # 32-bit integer ALU ops / s outside the tensor cores
    hbm_bw: float  # device-memory bytes / s
    source: str


PEAKS = {
    "NVIDIA H100 80GB HBM3": DeviceSpec(
        "NVIDIA H100 SXM",
        int32_ops=132 * 64 * 1.98e9,
        hbm_bw=3.35e12,
        source="NVIDIA H100 data sheet (SXM: 3.35 TB/s HBM3, 132 SMs, "
        "1.98 GHz boost, 700 W); 64 INT32 lanes per SM from the NVIDIA "
        "Hopper architecture white paper",
    ),
}


def device_spec(device_kind: str | None = None) -> DeviceSpec:
    """Peaks of ``device_kind`` (default: the first JAX device's)."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            "bench.roofline.PEAKS with its source"
        ) from None


def ops_per_edge(code: LdpcCode, spec: LayeredSpec) -> float:
    """Model of the 32-bit ALU operations per edge per iteration of the
    layered update (``ops.layered._layer_step_qc`` /
    ``kernels.pallas_layered``); per-check work is amortized over the mean
    check degree."""
    pre = spec.minclamp == "pre"
    n = 0
    n += 4  # VN row index: add shift, wrap compare, select, add column base
    n += 3  # contribution: sub + clip(min, max)
    n += 3 if pre else 1  # |v|: (clip(2) then abs) when pre, else abs
    n += 1  # sign compare (c > 0)
    n += 3  # running two-min: max, min, min
    n += 1  # parity xor
    n += 2  # magnitude select: cmp(a == min1) + where
    n += 3  # sign apply: xor, cmp, select
    n += 2 if pre else 0  # message post-clip
    n += 3  # APP update: add + clip(2)
    f_ops = {"MS": 2, "OMS": 6, "NMS": 4, "2NMS": 4}[spec.algo]
    mean_deg = code.M / max(code.n_checks, 1)
    return n + f_ops / mean_deg


def kernel_model(code: LdpcCode, spec: LayeredSpec, batch: int) -> dict:
    """Modelled operations and device-memory bytes of one decode call at
    the full iteration count: LLRs in and bits out once, and per edge and
    iteration one int8 APP read and write and one int8 message read and
    write (an upper bound: the L2 cache may absorb part of it)."""
    edges = code.M
    ops = spec.iters * edges * batch * ops_per_edge(code, spec)
    hbm_bytes = 2 * code.N * batch + 4 * edges * batch * spec.iters
    return {"int32_ops": ops, "hbm_bytes": hbm_bytes}


def roofline_report(
    code: LdpcCode,
    spec: LayeredSpec,
    batch: int,
    seconds: float,
    device_kind: str | None = None,
) -> dict:
    """Roofline share of a measured decode time against the table's peaks:
    the least time the card could take (the larger of ops over the ALU
    peak and bytes over the memory peak) over the measured time."""
    hw = device_spec(device_kind)
    m = kernel_model(code, spec, batch)
    t_ops = m["int32_ops"] / hw.int32_ops
    t_hbm = m["hbm_bytes"] / hw.hbm_bw
    bound = "alu" if t_ops >= t_hbm else "hbm"
    t_bound = max(t_ops, t_hbm)
    return {
        "hw": hw.name,
        "bound": bound,
        "ops_per_edge": round(ops_per_edge(code, spec), 2),
        "t_roofline_ms": t_bound * 1e3,
        "t_measured_ms": seconds * 1e3,
        "roofline_frac": t_bound / seconds if seconds else 0.0,
        "alu_util": (m["int32_ops"] / seconds) / hw.int32_ops,
        "hbm_util": (m["hbm_bytes"] / seconds) / hw.hbm_bw,
    }
