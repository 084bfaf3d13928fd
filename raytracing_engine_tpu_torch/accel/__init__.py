"""Acceleration structures: triangle meshes, the host-built BVH (traversed
by kernel K8), the cluster layout that kernel K6 sweeps, and instances of
one mesh (kernel K7) (raytracing_engine_tpu/accel)."""

from raytracing_engine_tpu_torch.accel.bvh import BVH, build_bvh, bvh_intersect  # noqa: F401
from raytracing_engine_tpu_torch.accel.clusters import (  # noqa: F401
    ClusterSet,
    build_clusters,
    cluster_set_from_numpy,
    visit_order,
    visit_orders,
)
from raytracing_engine_tpu_torch.accel.instancing import (  # noqa: F401
    InstancedClusters,
    InstancedMesh,
    grid_instances,
    instanced_intersect,
    make_instanced_clusters,
    make_instances,
)
from raytracing_engine_tpu_torch.accel.mesh import (  # noqa: F401
    icosphere,
    load_obj,
    save_obj,
    smooth_vertex_normals,
    torus_knot,
)
