"""Hand-written Hopper kernels for the visible-readers table and the paged
attention (CUDA C++ under ``../csrc``), their plain PyTorch versions
(``ref``), the wrappers that pick between them by the tensors' device
(``ops``), and the paged kernels' autotune sweep (``autotune``) with the
table their plans read (``tuning_table.json``)."""
