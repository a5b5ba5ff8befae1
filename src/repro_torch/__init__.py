"""PyTorch / CUDA port of the DMuon reproduction (the JAX package ``repro`` is
the reference).

Subpackages mirror ``repro``: ``core`` (optimizer), ``kernels`` (hand-written
Hopper kernels for the Gram Newton-Schulz products, with plain PyTorch
versions beside them), ``models``, ``configs``, ``data`` and ``train``.
Nothing here imports JAX; importing the package compiles nothing.
"""
