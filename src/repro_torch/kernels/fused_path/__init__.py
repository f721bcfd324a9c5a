"""Fused compacted path: Morton keys, the shared corner geometry and the fused
encode (plain version, CUDA kernel, autograd op)."""
