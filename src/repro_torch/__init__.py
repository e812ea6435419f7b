"""PyTorch/CUDA port of the `page_leap()` migration engine.

Mirrors the JAX package ``repro`` module by module and imports nothing of
it.  Entry points run on the current CUDA device unless the caller passes
``device="cpu"``; the kernels in ``kernels/csrc`` are built at first use.
"""
