"""Compression-side optimization utilities (the mixed-precision bit allocator)."""
