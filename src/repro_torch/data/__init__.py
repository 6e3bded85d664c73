"""Synthetic batches and input specs for the model entry points."""
from . import batches  # noqa: F401
