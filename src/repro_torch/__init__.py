"""PyTorch / CUDA port of the SiHGNN reproduction, for NVIDIA Hopper.

Mirrors the layout of the JAX package ``repro`` (``hetero``, ``core``,
``core.hgnn``, ``kernels``, ``pipeline``, ``api``) and never imports it or
JAX.  This slice runs banded HGNN inference end to end:
``api.Session(api.ExecutorSpec(na_executor="banded")).compile(...).forward``.
The two NA kernels are hand-written CUDA in ``csrc/na_kernels.cu``, built
with ``nvcc`` at first use.
"""
