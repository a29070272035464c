"""Utilities: CUDA build/dispatch, PGM I/O, JAX-state conversion."""

from . import io, viz  # noqa: F401
