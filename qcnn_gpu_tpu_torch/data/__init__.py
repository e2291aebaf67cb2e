"""Model files, YUV frames and sequence manifests (the port's own copies)."""
