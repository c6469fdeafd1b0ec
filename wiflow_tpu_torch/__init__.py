"""WiFlow on PyTorch and CUDA: the serving path of ``wiflow_tpu`` ported to one
NVIDIA H100, with hand-written Hopper kernels for its fused TPU kernels.

The package imports ``torch``, numpy and the standard library only; the
JAX package ``wiflow_tpu`` stays the numerical reference (tests compare the
two).  Layout mirrors ``wiflow_tpu/``: ``ops/kernels/`` holds the
counterparts of ``ops/pallas/``, their CUDA sources live in ``csrc/``.
"""
