"""Volume-rendering composite: plain version, CUDA kernel, dispatch."""
