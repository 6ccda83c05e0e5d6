"""PyTorch + CUDA port of the federated-momentum system (``repro``).

Mirrors the JAX package module for module; imports neither JAX nor
``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
