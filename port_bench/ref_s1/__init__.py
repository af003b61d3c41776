"""Frozen plain copies of the port's Stage-1 modules (commit badb067): the
benchmark's reference for Stage-1 SDF training."""
