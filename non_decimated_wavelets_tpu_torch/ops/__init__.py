"""Compute paths: ``direct_path`` (torch stencils, the CPU path and the
plain reference), ``level_ref`` and ``elemwise_ref`` (plain versions of the
kernels), ``cuda_kernels`` (the build of the hand-written CUDA kernels and
the per-level ones) and ``elemwise`` (the solvers' elementwise kernels)."""
