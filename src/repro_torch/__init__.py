"""PyTorch / CUDA port of the SiHGNN reproduction, for NVIDIA Hopper.

Mirrors the layout of the JAX package ``repro`` (``hetero``, ``core``,
``core.hgnn``, ``kernels``, ``pipeline``, ``api``) and never imports it or
JAX.  It runs banded HGNN inference end to end:
``api.Session(api.ExecutorSpec(na_executor="banded")).compile(...).forward``,
with the semantic graphs built on the host or, with
``sgb_backend="device"``, on the card.  The two NA kernels are hand-written
CUDA in ``csrc/na_kernels.cu`` and the SGB SpGEMM kernel in
``csrc/spgemm_kernels.cu``, built with ``nvcc`` at first use.
"""
