"""Fused small MLPs: plain versions, CUDA kernels, dispatch."""
