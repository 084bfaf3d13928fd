"""Frame throughput metrics, a stage timer and the kernels' least times.

Rays traced per frame (primary = every pyramid-level pixel; secondary = one
shadow ray per live light per output pixel) and the derived Mrays/s.

``bound_ms`` is the least time an H100 SXM could take for a kernel's work:
the larger of its bytes (each input read once, each output written once)
over 3.35 TB/s and its FP32 operations over 67 TFLOP/s (NVIDIA's data
sheet; 67 TFLOP/s counts an FMA as two operations, and the kernels build
with --fmad=false, so the rate they could reach is half of it). K9's work
is integer: its operations count against the INT32 rate, 132 SMs x 64
INT32 lanes x 1.98 GHz = 16.7 TOP/s (the Hopper architecture white paper's
SM; the data sheet lists no INT32 rate). The operation counts below are read
off the CUDA sources and count only the work every step or segment must
do, so the bound stays a lower one.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

H100_FP32_OPS_PER_S = 67e12
H100_INT32_OPS_PER_S = 132 * 64 * 1.98e9
H100_BYTES_PER_S = 3.35e12

# csrc/conemarch.cuh: one march step (march_ray or shadow_ray) does 12
# operations (position 6, radius 2, max, add, 2 compares) plus 3 per live
# object (the cache bound, its gate, the running min); the SDF it evaluates
# only where the gate opens is not counted
MARCH_STEP_OPS = 12
MARCH_STEP_OPS_PER_OBJECT = 3
RAY_DIR_OPS = 40            # ray_dir: normalized coords, rotation, normalize
SHADE_OPS = 30              # shade_pixel outside its loops
SHADE_OPS_PER_OBJECT = 11   # nearest-object SDF + compare
SHADE_OPS_PER_LIGHT = 45    # one light's Phong terms, without its march
# csrc/pt.cuh: one ray segment tests every live sphere (sphere_t + the
# caller's compares: 26) and every live triangle (tri_hit: 57)
PT_SPHERE_TEST_OPS = 26
PT_TRIANGLE_TEST_OPS = 57
# csrc/cluster.cuh, counted as the JAX package's cluster cost model does
# (raytracing_engine_tpu/accel/clusters.py:206): one box slab test with its
# gate 28 operations, one Baldwin–Weber triangle test 30. The counts of
# tests come from the plain sweep's replay of the same rays
# (ops/cuda/cluster.work), so they are what these inputs need.
CLUSTER_SLAB_OPS = 28
CLUSTER_TEST_OPS = 30
# csrc/bvh.cu (K8), by the same rule: one node test (slab, gate and the next
# link) 28 operations, one Möller-Trumbore test 57 (pt.cuh tri_hit's count);
# the counts of tests come from the plain traversal of the same rays
# (ops/cuda/bvh_traverse.work)
BVH_NODE_OPS = 28
BVH_TEST_OPS = PT_TRIANGLE_TEST_OPS
# csrc/instanced.cuh (K7): one instance's world-box gate 28 operations per
# ray and instance visited; the move to object space (3 subtractions, 2
# rotations of 15, 3 products and a reciprocal) 40 per ray and instance
# entered; the cluster sweeps inside by the cluster counts above
# (ops/cuda/instanced.work and ops/cuda/cluster.work)
INST_GATE_OPS = 28
INST_XFORM_OPS = 40
# csrc/rng.cu (K9), per element: 20 rounds of an add, a rotate (one funnel
# shift) and a xor; 12 key additions (the first 2, then 2 at each of the 5
# injections; a key word plus its round constant is the same for every
# thread); the xor of the two output words; the shift and the or that make
# the float's bits (one LEA.HI in the compiled kernel); one float
# subtraction: 75 integer operations and 1 float one. Only the 41 rotations
# and xors need the INT32 lanes: the compiler puts the 32 additions either
# there (IADD3) or on the FP32 pipe (IMAD.IADD), and the kernel's SASS has
# both. So the bound charges the 41 to the INT32 rate (all 75 integer
# operations over both pipes' 128 lanes would take less). The counter's
# index arithmetic is not counted. Each element writes 4 bytes, reads none.
RNG_INT32_OPS = 20 + 20 + 1
RNG_ELEMENT_BYTES = 4


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = H100_FP32_OPS_PER_S) -> tuple[float, str]:
    """(least ms on an H100 SXM, "bytes" or "operations": which bounds);
    n_ops at ops_per_s (FP32 unless given)."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rng_bound_ms(n_elements: int) -> tuple[float, str]:
    """K9's least time for n_elements uniforms: 41 operations on the INT32
    lanes and 4 bytes written each."""
    return bound_ms(RNG_ELEMENT_BYTES * n_elements, RNG_INT32_OPS * n_elements,
                    H100_INT32_OPS_PER_S)


def march_ops(steps: int, n_obj: int) -> int:
    """Operations of `steps` march steps over n_obj live objects."""
    return steps * (MARCH_STEP_OPS + MARCH_STEP_OPS_PER_OBJECT * n_obj)


def shade_ops(pixels: int, n_obj: int, n_light: int) -> int:
    """Per-pixel shading operations of K2/K3, without the shadow marches."""
    return pixels * (SHADE_OPS + SHADE_OPS_PER_OBJECT * n_obj + SHADE_OPS_PER_LIGHT * n_light)


def pt_ops(nrays: int, n_sph: int, n_tri: int) -> int:
    """Intersection operations of K4 for nrays segments (closest-hit and
    NEE shadow rays alike) against n_sph spheres and n_tri triangles."""
    return nrays * (PT_SPHERE_TEST_OPS * n_sph + PT_TRIANGLE_TEST_OPS * n_tri)


def sweep_ops(slabs: int, tests: int) -> int:
    """Operations of a cluster sweep that ran `slabs` box tests and `tests`
    triangle tests (K6, and the sweeps inside K4 and K5)."""
    return slabs * CLUSTER_SLAB_OPS + tests * CLUSTER_TEST_OPS


def bvh_ops(nodes: int, tests: int) -> int:
    """Operations of a BVH traversal that ran `nodes` node tests and `tests`
    triangle tests (K8)."""
    return nodes * BVH_NODE_OPS + tests * BVH_TEST_OPS


def instanced_ops(gates: int, transforms: int, slabs: int, tests: int) -> int:
    """Operations of a two-level sweep (K7, and the sweeps inside K4 and K5
    with instances): instance gates and transforms, then the cluster
    sweeps' box and triangle tests."""
    return gates * INST_GATE_OPS + transforms * INST_XFORM_OPS + sweep_ops(slabs, tests)


def cluster_table_bytes(tables) -> int:
    """Bytes of a ClusterSet's kernel records (ops/cuda/cluster.sweep_tables)
    plus the frame's visit orders: read once by a launch."""
    return sum(4 * t.numel() for t in tables if t is not None)


def k6_bytes(n_rays: int, attrs: bool, table_bytes: int, tmax_plane: bool = False,
             uv: bool = False, tan: bool = False) -> int:
    """K6 reads 6 planes per ray (o, d), 7 when the caller passes a t_max
    plane, and writes 2 (t, slot), 7 with the attributes, 9 with a UV
    table's (u, v) (uv) and 12 with its tangent planes too (tan), besides
    the tables (the UV records among them)."""
    out = (7 + 2 * int(uv) + 3 * int(tan)) if attrs else 2
    return 4 * n_rays * (6 + int(tmax_plane) + out) + table_bytes


# what K8 reads per node and triangle: a node's whole 32-byte record (its box
# and its packed first, count and skip, two float4 loads); a triangle's v0,
# e1 and e2 (9 f32; the record's padding is not counted)
BVH_NODE_BYTES = 32
BVH_TRI_BYTES = 36


def k8_bytes(n_rays: int, n_nodes: int, n_tris: int, tmax_plane: bool = False) -> int:
    """K8 reads 6 planes per ray (o, d), 7 when the caller passes a t_max
    plane, and writes 2 (t, idx), besides the node and triangle fields it
    reads."""
    return (4 * n_rays * (6 + int(tmax_plane) + 2)
            + BVH_NODE_BYTES * n_nodes + BVH_TRI_BYTES * n_tris)


def k7_bytes(n_rays: int, attrs: bool, table_bytes: int, tmax_plane: bool = False,
             uv: bool = False, tan: bool = False) -> int:
    """K7 reads 6 planes per ray (o, d), 7 when the caller passes a t_max
    plane, and writes 2 (t, code), 5 with the world normal, 7 with a UV
    base table's (u, v) (uv) and 10 with its world tangent too (tan),
    besides the base set's records (its UV records among them), the
    instance table and the orders."""
    out = (5 + 2 * int(uv) + 3 * int(tan)) if attrs else 2
    return 4 * n_rays * (6 + int(tmax_plane) + out) + table_bytes


def k5_bytes(n_rays: int, live: list, table_bytes: int, planes: int = 17) -> int:
    """One pass of K5 launches (bounces 0..len(live)) over a state of n_rays
    rays with `planes` planes (wavefront.state_plane_count: 17, and one more
    each for a dispersive scene's chan and the trilinear filter's tacc):
    bounce 0 writes the whole state; each later launch reads every ray's
    o.x (the parked test) and, for the live[b - 1] rays it finds not parked,
    the rest of the state, and writes those back; each launch reads the
    tables. live: this run's rays not parked before each later launch."""
    later = sum(4 * n_rays + 4 * (2 * planes - 1) * k for k in live)
    return 4 * planes * n_rays + later + (1 + len(live)) * table_bytes


class Timer:
    """Wall-clock stage timer (raytracing_engine_tpu/utils/timing.py Timer).
    CUDA launches return before the card has run them: when timing device
    work, call torch.cuda.synchronize() before stop."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._start = {}

    def start(self, name: str):
        self._start[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        dt = time.perf_counter() - self._start.pop(name)
        self.totals[name] += dt
        self.counts[name] += 1
        return dt

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts[name], 1)

    def summary(self) -> dict:
        return {k: self.mean(k) for k in self.totals}


@dataclasses.dataclass
class FrameStats:
    """Ray accounting for one rendered frame."""

    primary_rays: int      # pyramid pixels (all levels)
    secondary_rays: int    # shadow rays launched
    seconds: float

    @property
    def total_rays(self) -> int:
        return self.primary_rays + self.secondary_rays

    @property
    def mrays_per_sec(self) -> float:
        return self.total_rays / self.seconds / 1e6

    @property
    def fps(self) -> float:
        return 1.0 / self.seconds


def conemarch_ray_count(cfg, num_lights: int) -> tuple[int, int]:
    """(primary, secondary) rays per frame for the cone-march renderer.

    Primary: one march per pixel per pyramid level (every level is marched
    every frame, reference src/main.rs:300-316). Secondary: one shadow ray per
    live light per output pixel (fragment.glsl:170-176).
    """
    primary = sum(w * h for (w, h) in cfg.level_dims)
    secondary = cfg.width * cfg.height * num_lights
    return primary, secondary
