"""Ops: region geometry and the hand-written CUDA kernels."""
