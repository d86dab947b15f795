"""Layer implementations with hand-written kernels (flash attention)."""
