"""Attention op and the hand-written Hopper kernels behind it."""
