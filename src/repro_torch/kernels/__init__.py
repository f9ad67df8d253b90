"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions
(``ref``) and the dispatch by device (``ops``)."""
