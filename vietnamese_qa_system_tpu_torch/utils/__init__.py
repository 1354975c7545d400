"""Helpers: JAX-order parameter trees, experiment trackers, logging and
base-call contracts."""

from .logging import dist_print, get_logger, in_notebook

__all__ = ["dist_print", "get_logger", "in_notebook"]
