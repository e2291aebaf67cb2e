"""QVRCNN parameter containers and the reference forward."""
