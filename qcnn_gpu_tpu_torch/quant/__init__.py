"""Fixed-point quantization tables and their solver (the port's own copies)."""
