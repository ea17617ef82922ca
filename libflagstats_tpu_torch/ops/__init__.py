"""Counting tiers of the port: plain torch ops, the CUDA kernel and its
plain twin, and the size-tiered dispatch over them."""
