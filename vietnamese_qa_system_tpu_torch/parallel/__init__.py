"""Placement over the device mesh: the collectives of one controller and
the parameter sharding rules of the tensor-parallel reader."""

from .collectives import all_gather, all_reduce_sum

__all__ = ["all_gather", "all_reduce_sum"]
