"""PyTorch/CUDA port of the LLM-QFL reproduction (``repro``).

A second package beside the JAX one, which stays the reference: every
module here keeps its counterpart's name and layout and is tested against
it on identical inputs (``tests/test_torch_*.py``).  It imports torch and
numpy, never JAX and nothing of ``repro``.  The hand-written CUDA kernels
(``kernels/csrc/``) are built at first use on a machine with ``nvcc``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where each kernel's plain PyTorch version runs instead.
"""
