"""PyTorch / CUDA port of the ``repro`` serving engine.

Mirrors ``src/repro``'s layout (``configs``, ``core``, ``models``,
``kernels``, ``tokenizer``, ``grammar``) and imports only ``torch``,
numpy and the standard library — never JAX and never ``repro``.  Entry
points run on the current CUDA device unless the caller passes
``device="cpu"``.
"""
