#!/usr/bin/env python3
"""Headline throughput benchmark — decoded coded-Mbit/s on one GPU.

Config matches the paper's largest published per-config figure at equal
iteration count: the (2304,1152) 802.16e QC code, 10 layered OMS
iterations, batch 8192, vs 132 Mbps (GTX 680, 3 streams,
``paper/ldpcGpuTegra.tex:345``).  Throughput accounting is the
reference's: coded bits per wall second (``code/gpu_fixed/main.cpp:311-315``).

Prints ONE JSON line naming the device it ran on.  Exits non-zero when JAX
sees no GPU: there is no CPU fallback and no replay of old numbers.
"""

from __future__ import annotations

import json
import sys

import jax

BASELINE_MBPS = 132.0  # GTX 680, 3 streams, 10 iters, (2304,1152)


def main() -> int:
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench: no GPU visible to JAX (devices: {devs})",
              file=sys.stderr)
        return 1
    from ldpcgputegra.bench import measure_call, throughput_report
    from ldpcgputegra.channel.awgn import AwgnChannel, ChannelSpec
    from ldpcgputegra.codes.registry import load_code
    from ldpcgputegra.decoder import backend_for, make_decoder
    from ldpcgputegra.ops.layered import LayeredSpec
    from ldpcgputegra.utils import enable_compile_cache

    enable_compile_cache()
    code = load_code("2304x1152")
    batch = 8192
    spec = LayeredSpec(algo="OMS", iters=10, early_term=False)
    decoder = make_decoder(code, spec)
    chan = AwgnChannel(code.N, code.K, ChannelSpec())
    chan.configure(3.0)
    inputs = [
        chan.generate_zero_int8(jax.random.key(i), batch) for i in range(4)
    ]
    rep = throughput_report(measure_call(decoder, inputs), batch, code.N)
    print(
        f"(PERF) 2304x1152 OMS 10it [{backend_for(code, spec)}]: "
        f"{rep['ms_per_call']:.3f} ms/call, {rep['coded_gbps']:.3f} Gbps",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": "decode_throughput_2304x1152_oms_10it",
        "value": round(rep["coded_mbps"], 1),
        "unit": "coded-Mbps/card",
        "vs_baseline": round(rep["coded_mbps"] / BASELINE_MBPS, 2),
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
