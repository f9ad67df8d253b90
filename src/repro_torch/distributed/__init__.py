"""Placement of the batched engines' client axis over several devices."""
