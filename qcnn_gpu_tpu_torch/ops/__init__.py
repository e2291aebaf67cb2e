"""Integer epilogues, the fused-network kernel wrapper and its build."""
