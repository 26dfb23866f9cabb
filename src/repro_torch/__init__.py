"""PyTorch/CUDA port of the 3SFC federated-learning system.

The JAX package ``repro`` is the reference; this package keeps its
subpackage and module names (``configs``, ``core``, ``kernels``,
``models``, ``data``, ``fl``, ``launch``) and imports nothing of it.
"""
