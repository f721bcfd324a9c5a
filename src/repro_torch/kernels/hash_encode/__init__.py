"""Multiresolution hash-grid encode: plain version, CUDA kernel, dispatch."""
