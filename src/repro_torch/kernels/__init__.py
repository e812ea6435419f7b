"""Hand-written CUDA kernels of the port (``csrc/``), their wrappers, their
plain PyTorch versions (``ref``) and the dispatcher (``ops``)."""
