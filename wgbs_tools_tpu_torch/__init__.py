"""PyTorch + CUDA port of wgbs_tools_tpu for NVIDIA Hopper (H100).

The JAX package `wgbs_tools_tpu` stays the reference. This package re-runs
its pipelines with PyTorch tensors and hand-written CUDA kernels
(`csrc/*.cu`, built with nvcc for sm_90a at first CUDA use). Its jax-free
host modules (`formats`, `genome`, `native`, `utils`) are imported, not
copied. Importing this package never imports jax.

Ported so far: `pat2beta` (`pipeline.pat2beta`, CLI
`python -m wgbs_tools_tpu_torch pat2beta`) on one GPU, over site shards
on several devices (`parallel.sharded`) and over worker processes
(`--procs`, `parallel.multihost`).
"""

__version__ = "0.1.0"
