"""One-op shade stage (encode both grids + both MLP heads): plain version,
CUDA forward and backward kernels, autograd op."""
