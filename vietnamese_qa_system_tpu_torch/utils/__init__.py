"""Helpers: JAX-order parameter trees and experiment trackers."""
