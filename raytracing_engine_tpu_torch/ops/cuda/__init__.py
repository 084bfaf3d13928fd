"""Hand-written CUDA kernels (csrc/) and their wrappers.

Each wrapper module holds one kernel's wrapper, its plain PyTorch version and
a plain-integer ``launches`` count:

- ``depth``  — K1, one depth-pyramid level
- ``fused``  — K2, the finest level's march + shading
- ``shade``  — K3, shading from a finished depth image
- ``pt``     — K4, the sphere path tracer (megakernel), with pack_pt_scene

``common`` builds one library per csrc/*.cu source and launches entries.
"""
