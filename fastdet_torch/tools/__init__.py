"""Command-line tools of the port that are not entry points of a
workflow (counterpart of the JAX package's `tools/`)."""
