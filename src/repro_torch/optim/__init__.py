"""Batched gradient-free optimizers."""
