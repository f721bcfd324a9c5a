"""BUM-merged table-gradient commits: plain versions, CUDA kernel, dispatch."""
