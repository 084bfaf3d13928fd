"""Acceleration structures: triangle meshes, the host-built BVH and the
cluster layout that kernel K6 sweeps (raytracing_engine_tpu/accel)."""

from raytracing_engine_tpu_torch.accel.bvh import BVH, build_bvh  # noqa: F401
from raytracing_engine_tpu_torch.accel.clusters import (  # noqa: F401
    ClusterSet,
    build_clusters,
    cluster_set_from_numpy,
    visit_order,
    visit_orders,
)
from raytracing_engine_tpu_torch.accel.mesh import (  # noqa: F401
    icosphere,
    load_obj,
    save_obj,
    smooth_vertex_normals,
    torus_knot,
)
