"""Renderers.

- ``conemarch``     — plain PyTorch depth-pyramid renderer (reference parity);
                      the oracle for the CUDA kernels and the CPU path
- ``cuda_renderer`` — the same frame through the hand-written CUDA kernels
"""
