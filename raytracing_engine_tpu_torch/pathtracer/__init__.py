"""The path tracer (raytracing_engine_tpu/pathtracer, the ported part):
spheres, unrolled triangles and meshes as ClusterSets.

    integrator.py  PTConfig (every field of the JAX config),
                   tree_cluster_weights
    sampler.py     ONB, cosine hemisphere, sphere/triangle area samples, MIS,
                   the GGX microfacet functions (isotropic and anisotropic)
    scene.py       PTScene (with the METAL, rough-glass, checker, image,
                   UV, dispersion, sky, env-map, mesh-light and light-tree
                   columns and tables), build_pt_scene, pt_scene_from_numpy,
                   pack_texture_atlas, build_env_map, mesh_light_rows
    sceneio.py     JSON scene files: load_scene_json, SceneBundle
    scenes.py      furnace_scene, cornell_box, material_spheres
    wavefront.py   the plain PyTorch path tracer (render_pt_fast, the staged
                   per-bounce state), the oracle of K4 and K5
    aov.py         render_aovs: first-hit albedo, normal, depth (and AO)
    denoise.py     the AOV-guided à-trous denoiser
    temporal.py    temporal reprojection accumulation

``render_pt_mega`` (kernel K4) and ``render_pt_rebin`` (K5) live in
ops/cuda/pt.py; ``render_pt_mega`` is re-exported here lazily, as the JAX
package does.
"""

from raytracing_engine_tpu_torch.pathtracer.scene import (  # noqa: F401
    DIELECTRIC,
    DIFFUSE,
    EMISSIVE,
    METAL,
    MIRROR,
    PTScene,
    build_pt_scene,
    pt_scene_from_numpy,
)
from raytracing_engine_tpu_torch.pathtracer.integrator import PTConfig  # noqa: F401
from raytracing_engine_tpu_torch.pathtracer.wavefront import render_pt_fast  # noqa: F401
from raytracing_engine_tpu_torch.pathtracer.sceneio import (  # noqa: F401
    SceneBundle,
    load_scene_json,
)
from raytracing_engine_tpu_torch.pathtracer.aov import render_aovs  # noqa: F401
from raytracing_engine_tpu_torch.pathtracer.denoise import denoise  # noqa: F401
from raytracing_engine_tpu_torch.pathtracer.temporal import (  # noqa: F401
    TemporalState,
    temporal_init,
    temporal_noise,
    temporal_step,
)


def render_pt_mega(*args, **kwargs):
    """Megakernel path tracer (lazy import — see ops/cuda/pt.py)."""
    from raytracing_engine_tpu_torch.ops.cuda.pt import render_pt_mega as f

    return f(*args, **kwargs)
