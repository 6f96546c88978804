"""Shared utilities."""

from .cache import enable_compile_cache

__all__ = ["enable_compile_cache"]
