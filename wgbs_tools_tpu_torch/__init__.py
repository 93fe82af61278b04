"""PyTorch + CUDA port of wgbs_tools_tpu for NVIDIA Hopper (H100).

The JAX package `wgbs_tools_tpu` stays the reference. This package re-runs
its pipelines with PyTorch tensors and hand-written CUDA kernels
(`csrc/*.cu`, built with nvcc for sm_90a at first CUDA use). It keeps its
own copy of the host layer it needs (`formats`, `genome`, `native` with
its C++ source `host/wgbsio.cpp`, built with g++ at first use, `utils`):
importing this package imports neither jax nor anything of
wgbs_tools_tpu.

Its command line (`python -m wgbs_tools_tpu_torch`, installed as
`wgbstools-torch`) has every command of the JAX CLI (`cli/main.py`).
"""

__version__ = "0.1.0"
