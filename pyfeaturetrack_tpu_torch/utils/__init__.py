"""Utilities: CUDA build/dispatch, PGM I/O, JAX-state conversion."""
