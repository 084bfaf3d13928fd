"""Renderers.

- ``conemarch``     — plain PyTorch depth-pyramid renderer (reference parity);
                      the oracle for the CUDA kernels and the CPU path
- ``cuda_renderer`` — the same frame through the hand-written CUDA kernels
- ``golden``        — the scalar numpy golden renderer (per-pixel loops; a
                      copy of the JAX package's), the repo's first oracle
- ``instanced``     — Phong-shaded frames of instanced scenes (BASELINE
                      config 5) through kernel K7
"""

from raytracing_engine_tpu_torch.models.instanced import render_instanced_phong  # noqa: F401
