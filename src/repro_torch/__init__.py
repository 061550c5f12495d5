"""PyTorch/CUDA port of the dynamic-graph framework (``repro``).

Same sub-package layout as the JAX package, module for module; every
Pallas kernel on the ported path is a hand-written CUDA kernel under
``csrc/`` with a plain PyTorch version beside it (``kernels/ref.py``).
"""
