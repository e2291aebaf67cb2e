"""Inference engine (program cache, batched restore) and metrics log."""
