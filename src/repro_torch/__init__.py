"""PyTorch/CUDA port of the ``repro`` package (GPU First on an NVIDIA H100).

The JAX package ``repro`` is the reference; this package mirrors its module
names so each counterpart is easy to find.  It imports ``torch`` and never
``jax`` or ``repro``.  Entry points run on the card (``device="cuda"``)
unless the caller asks for ``device="cpu"``.
"""
