"""The systems under test, one module per way of serving a configuration."""
