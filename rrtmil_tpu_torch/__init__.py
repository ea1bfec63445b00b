"""PyTorch/CUDA port of rrtmil_tpu: RRT-MIL, its classification CLI
(`python -m rrtmil_tpu_torch.main`) and survival training.

The JAX package `rrtmil_tpu` stays the reference; this package imports
neither it nor JAX.  The kernels under `csrc/` are hand-written CUDA for
Hopper (sm_90a), built at first use by `ops/kernels/build.py`.
"""
