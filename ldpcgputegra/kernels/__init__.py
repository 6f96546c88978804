"""Pallas GPU kernels — the fused decode path for QC codes."""

from .pallas_layered import make_pallas_decoder, pallas_supported

__all__ = ["make_pallas_decoder", "pallas_supported"]
