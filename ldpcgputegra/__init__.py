"""ldpcgputegra — LDPC decoding framework for GPUs on JAX.

Capability parity with boiseHPSim/ldpcGpuTegra (see PARITY.md), built on
JAX/XLA with a Pallas-Triton kernel for QC codes.  Top-level convenience surface:

    from ldpcgputegra import load_code, make_decoder, LayeredSpec
    code = load_code("1944x972")
    decode = make_decoder(code, LayeredSpec(algo="OMS", iters=10))
    bits, iters_used = decode(llr_int8)   # [B, N] int8 -> bits

Subpackages: codes, quant, channel, golden, ops, kernels, decoder,
parallel, sim, bench, utils; native C++ in native/.
"""

__version__ = "0.1.0"

from .codes.registry import list_codes, load_code  # noqa: F401
from .decoder import LayeredSpec, make_decoder  # noqa: F401

__all__ = ["list_codes", "load_code", "LayeredSpec", "make_decoder"]
