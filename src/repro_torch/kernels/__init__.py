"""Hand-written Hopper kernels for the visible-readers table (CUDA C++ under
``../csrc``), their plain PyTorch versions (``ref``) and the wrappers that
pick between them by the tensors' device (``ops``)."""
