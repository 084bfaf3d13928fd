"""Hand-written CUDA kernels (csrc/) and their wrappers.

Each wrapper module holds one kernel's wrapper, its plain PyTorch version and
a plain-integer ``launches`` count:

- ``depth``  — K1, one depth-pyramid level
- ``fused``  — K2, the finest level's march + shading
- ``shade``  — K3, shading from a finished depth image
- ``pt``     — K4, the path-tracing megakernel (spheres, unrolled
  triangles or a ClusterSet), and K5, one bounce per launch with the
  regroup between launches (render_pt_rebin)
- ``cluster`` — K6, the cluster sweep of a ClusterSet (closest / any hit)
- ``instanced`` — K7, the two-level sweep over instances of a ClusterSet
- ``bvh_traverse`` — K8, the skip-link traversal of a raw BVH
- ``rng`` — K9, threefry2x32 uniforms (the path tracer's ``"threefry"`` and
  ``"pallas"`` draws)

``common`` builds one library per csrc/*.cu source and launches entries.
"""
