"""Hand-written kernels and the attention dispatch."""
