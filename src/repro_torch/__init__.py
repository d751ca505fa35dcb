"""PyTorch / CUDA port of the ``repro`` package (runs on an NVIDIA H100).

Imports torch and numpy only, never JAX and nothing of ``repro``.
"""
