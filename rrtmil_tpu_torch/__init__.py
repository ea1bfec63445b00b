"""PyTorch/CUDA port of rrtmil_tpu: the c16_r50 inference path.

The JAX package `rrtmil_tpu` stays the reference; this package imports
neither it nor JAX.  The kernels under `csrc/` are hand-written CUDA for
Hopper (sm_90a), built at first use by `ops/kernels/build.py`.
"""
