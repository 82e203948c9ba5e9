"""Ops with hand-written Hopper kernels: :mod:`.flash_attention`."""
