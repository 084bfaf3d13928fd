#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raytracing_engine_tpu_torch) on one GPU.

Phases, each printing its own lines:
  1. the card's name and power limit; the CUDA kernels built from csrc/;
  2. each kernel against its plain PyTorch version on the card, at the
     1920x1088 configuration's shapes (atol 2e-5, rtol 1e-5, at most 1e-4 of
     the elements diverging); K1, the pyramid in one launch, bit for bit
     against the plain pyramid at every level, at 1920x1088 and 1280x720, for
     levels 0..N-1 and 0..N-2 in one launch and for each level alone; K2 and
     K3 bit for bit;
  3. the fused renderer against the two-kernel renderer, bit for bit; then
     K2 and K3 against their plain versions and fused == two-kernel, bit
     for bit, on their hard cases: every object, material and light slot
     live (8 spheres, 8 lights), no light, 1280x720, and 1000x504 (a finest
     level that K2's and K3's block tiles do not divide);
  4. a 64x64 render against tests/golden/golden_64.npz; the port's own
     numpy golden renderer (models/golden.py) renders that artifact bit for
     bit;
  5. the main path at 1920x1088 through its user entry points (FrameLoop,
     render_sequence) under the kernels' launch counters; the first frame
     written through utils.image.write_png to smoke_out/ (gitignored) and
     its pixel rows read back from the file equal to to_srgb_u8 of the
     frame;
  6. timings of each kernel (K1, K2 and K3 by torch.profiler's device
     time, CUDA events beside) and of the whole frame by CUDA events (host
     enqueue beside), beside the plain versions and each kernel's least
     time (utils/timing.bound_ms);
  7. the path tracer's kernel K4 against its plain version on the card at
     BASELINE config 2 (material_spheres, 800x608, 4 bounces, 4 spp) and one
     config-4 chunk (cornell_box, 256x256, 4 bounces, 128 spp), held to the
     repo's megakernel-vs-wavefront bounds (tests/test_megakernel.py:37-40:
     < 1% of pixels off by more than 1e-3, mean difference < 1e-4, ray
     counts within max(8, 1e-3 n)), and whether the match is bitwise; then
     K4's instantiation without a mesh on a band ragged in both directions
     (509 columns, an odd row count) at 3 spp with Russian roulette, bit for
     bit (phases 11 and 14 do the same for the cluster and instance
     instantiations);
  8. physics and invariants through K4: furnace corners at 1.0 (atol 1e-4),
     bands equal to the rows of the full render bit for bit, the first two
     128-spp chunks of progressive_render equal to one 256-spp render within
     the float-summation bound, glass Cornell finite and lit;
  9. the path tracer's main path under the launch counter, timed by CUDA
     events: config 2 frames with distinct camera z (and their device time
     by torch.profiler), config 4's 1024 spp through progressive_render,
     material_spheres at 1920x1088 and 4 spp; then the plain version's
     config-2 frame, K4's device time of a config-2 frame (the profiler's)
     and K4's least times at config 2 and at 1080p;
 10. BASELINE config 3's ClusterSet (the 70,400-triangle torus knot of
     benchmarks/run_all.py:120-148, built on the host, BVH builder named)
     and kernel K6 against its plain version on the card, bit for bit: the
     512x512 camera rays and the bounce-1 rays of one pass (closest hit with
     attributes), NEE-style shadow rays (any hit, t_max = 0.999 of the
     light distance), and axis-parallel and parked rays against a padded
     set; K6 timed on the camera rays by torch.profiler's device time (CUDA
     events beside);
 11. the config-3 path and its invariants at 512x512, 2 bounces, 1 spp,
     seed_from_int(1): render_pt_rebin (K5) == render_pt_mega(bvh=cs) (K4)
     bit for bit in every regroup mode; K5 and K4 against their plain
     versions on the whole frame, within the megakernel bounds (K4's replay
     counts the work of its least time), and 64-row bands of both bit for
     bit the rows of the full render; render_pt_fast(bvh=cs) through K6
     within the megakernel bounds of K4; progressive_render(bvh=cs) in two chunks
     against one render; K4's cluster instantiation on a ragged band (509
     columns, 5 rows) at 3 spp with Russian roulette against its plain
     version bit for bit; then K5's warp sweep on the rays where it can
     break, one bounce on a state of them against the plain version bit for
     bit: rays at the knot's shared vertices and edges, rays
     grazing its cluster boxes, a warp whose lanes pick different visit-order
     rows, and the duplicated icosphere of tests/test_torch_cluster.py (every
     hit an exact tie) hit at its vertices and by axis-parallel and parked
     rays; every set ends in a ragged warp (n % 32 of 13, 7, 31, 5 and 1);
     K6's warp sweep on the same rays against its plain version bit for
     bit, closest hit with attributes and the frame's visit orders, and
     any hit;
 12. the config-3 main path under the launch counters, timed by CUDA events:
     render_pt_rebin at 512x512 and 1920x1088 (chained frames with distinct
     camera z, best of 3 rounds, host enqueue beside), its torch.profiler
     split (K5 per bounce, sort, permute, un-permute), render_pt_mega(bvh=cs)
     at 512x512, render_pt_fast(bvh=cs), progressive_render(bvh=cs); then K5
     per bounce alone (the profiler's device time), K4 alone on the frame
     of phase 11 and the K4 / K5 / K6 least times;
 13. config 3's mesh as a raw BVH (accel.build_bvh) and kernel K8 against
     its plain version on the card, bit for bit: the 512x512 camera rays and
     the bounce-1 rays (closest hit), the NEE-style shadow rays (any hit,
     t_max = 0.999 of the light distance), axis-parallel and parked rays,
     the duplicated icosphere (every hit a tie) at its vertices and edges,
     walks cut at max_steps = 7 (the icosphere) and 24 (the camera rays),
     and ragged ray counts through the knot (a 13 x 509 band and 507 rays of
     the middle row, neither a whole number of warps); K8 timed on the camera, bounce-1 and shadow rays (device time
     by torch.profiler), beside K6 on the camera rays, and K8's least time;
 14. BASELINE config 5 (benchmarks/run_all.py:317-500: 30 instances of a
     35,200-triangle torus knot, 1,056,000 triangles) and kernel K7 against
     its plain version, bit for bit: on 2 x 2 instances of the knot at
     512x512 (closest with normals, then render_instanced_phong's shadow
     rays from those hits, misses and back faces parked) and on
     axis-parallel and parked rays against two scaled instances;
     render_instanced_phong (hard and soft shadows) through K7 against its
     plain version on a band of the 1920x1088 frame at the full 30
     instances (the instances its rows hit logged), bands equal to the rows
     of the full frame; the path-traced cell at 512x512: render_pt_rebin ==
     render_pt_mega(bvh=InstancedClusters) in every regroup mode, the 2 rows
     whose camera rays hit the most instances through K4 and K5 equal to the
     rows of the full frame and K5 against its plain version there, K4
     against its plain version on every 8th row of the frame (its replay
     counts the work of K4's least time, scaled to the frame by the rays
     traced), render_pt_fast(bvh=InstancedClusters)
     through K7 against K4; K4's instance instantiation on a ragged band
     (509 columns, 5 rows) of two scaled icosphere instances at 3 spp with
     Russian roulette against its plain version bit for bit; then K7's and K5's
     warp sweeps with instances on the rays
     where they can break, bit for bit: rays at the world vertices and edges of the knot instances, rays grazing
     the instances' world boxes, two instances of the duplicated icosphere
     (ties) hit at their vertices and by axis-parallel and parked rays,
     each set ending in a ragged warp;
 15. the slice's main paths under the launch counters, timed by CUDA events
     (best of 3 rounds, host enqueue beside): the config-5 Phong orbit (8
     chained 1920x1088 frames, hard shadows), its soft-shadow orbit (4
     frames), the config-5 path-traced cell through render_pt_rebin and
     render_pt_mega (then K4 alone on the frame of phase 14, beside its
     least time), config 3 through render_pt_fast with the raw BVH; the
     torch.profiler split (K7 closest against any hit per Phong frame, K5
     per bounce); then K7 alone on a full Phong frame's camera rays (the
     profiler's device time), held to its plain version bit for bit, and
     its least time;
 16. kernel K9 (threefry2x32 uniforms) against its plain version, bit for
     bit, at (8, 1088, 1920) and on a band of rows 517..581, and against
     literal values of jax.random.uniform(PRNGKey(0), ...) and of the JAX
     package's uniform_planes(-7, ...) taken on the CPU; the slice's main
     path under the launch counters: render_pt_fast at BASELINE config 2's
     scene and size (800x608, 4 bounces, 4 spp, PRNGKey(1)) at the default
     rng="threefry", then at rng="pallas", timed by CUDA events, their mean
     against K4's pcg render of the same scene, a band of trace_pass_soa
     against the rows of the full pass bit for bit; progressive_render's
     default route (render_pt_fast with the state's key) chunk-invariant at
     config 4, and through config 3's ClusterSet (K6 and K9) and raw BVH
     (K8 and K9); K9 timed by CUDA events and by torch.profiler, beside its
     plain version, its least time and torch.rand (Philox, another stream,
     for scale only);
 17. the cone-march serving path as the JAX package's cmd_replay drives it
     (cli.py:136-179), under the launch counters: a 24-event FrameLoop
     session at 1920x1088 (movement, mouse look, focus lost and regained, a
     fullscreen toggle to 1280x720 and back) recorded through Recorder, its
     frames written by ApngWriter and VideoWriter into smoke_out/ (a file of
     each per frame size), save_replay / load_replay, and the replay frame
     by frame and with chunk=8: every replayed frame bit for bit the
     recorded run's, the APNG read back equal to to_srgb_u8 of each frame,
     the y4m within 3 LSB (tests/test_replay_video.py:90-105), one K1 and
     one K2 a rendered frame; stage times by CUDA events with the
     profiler's device time beside (utils/profiling.py);
 18. the AOV / temporal / denoise path: (a) render_aovs on the card (K9
     with K6, K8 or K7; AO radius 1) against the same call on the CPU at
     160x96 through config 3's ClusterSet, its raw BVH and two icosphere
     instances (hit flags equal and the planes within atol / rtol 1e-5 on
     all but 1e-3 of the pixels); (b) temporal_step and denoise on an
     orbit frame's planes, card against CPU, within atol / rtol 2e-5; (c)
     at a static pose with six keys, the output the running mean on the
     pixels with full history (tests/test_temporal.py:42-61); (d) the
     denoiser's gain on tests/test_denoise.py:22-49's scene and size,
     through K4 and through render_pt_fast at the test's threefry stream;
     and the denoised temporal orbit (JAX cli.py _pt_orbit --temporal and
     pt --denoise) at 1920x1088 through config 3's ClusterSet:
     render_pt_mega, render_aovs, temporal_step,
     denoise(noise=temporal_noise(state)), tonemap and ApngWriter for 8
     poses under the launch counters, each stage timed by CUDA events, one
     frame again under the profiler for its device time by stage;
 19. the showcase scene, examples/showcase.json (JAX cli.py:312-336),
     loaded onto the card by load_scene_json with its 320-triangle smooth
     icosphere as a ClusterSet: K4's material instantiation against its
     plain version bit for bit on rows 536..551 at 1920 columns (1 spp;
     the replay's work, scaled to the frame, gives the bound) and on a
     ragged band, K5 == K4 there (the 18-plane state); the 1920x1088,
     4-spp, 4-bounce frame through render_pt_mega, render_pt_rebin,
     render_pt_fast(bvh=cs) and progressive_render under the launch
     counters, K4 and K5 by the profiler's device time; the card against
     the plain version on the CPU at 64x36 (the CPU's sqrt made correctly
     rounded; the pixels its own sqrt moves logged); dispersion 0 and a
     checker of scale 0 bit for bit the scene without them, also with the
     column present and zero, at 256x144; a tonemapped PNG.
 20. the showcase with the rest of the material features, written to a
     temporary directory from examples/showcase.json's dict (the file
     unchanged): the gradient sky replaced by a 64x128 equirect HDR map
     made with numpy (a gradient and a sun disc of radiance 200 at 35
     degrees' elevation, .npy, "rows": 32), a rough-glass sphere (ior 1.5,
     roughness 0.25), a diffuse sphere with a UV-space checker (scale 8),
     and the icosphere as an OBJ with spherical vt ("uvs": true) under a
     32x64 numpy-made PNG texture (the atlas holds 32 rows): K4's material instantiation bit for bit
     with its plain version on rows 536..551 at 1 spp, nearest and
     bilinear, K5 == K4 there and K5 against its plain version; K6's nine
     planes (the UV pair) on the frame's camera rays bit for bit with the
     plain sweep, K6 timed there; the 1920x1088, 4-spp, 4-bounce bilinear
     frame through render_pt_mega, render_pt_rebin and
     render_pt_fast(bvh=cs) under the launch counters, K4 and K5 by the
     profiler's device time, bounds from the band's replay scaled by the
     frame's rays; the card against the plain version on the CPU at 64x36
     within the megakernel bounds; K4<none, material> on unrolled slots
     with tri_uvs bit for bit with its plain version; roughness 0 bit for
     bit the glass without the key (also with the rough-glass branch
     forced on), and unused UV and image materials bit for bit the
     showcase without them, at 256x144; a tonemapped PNG.
 21. the entry points as a user starts them: (a) a LiveFrameServer over a
     1920x1088 FrameLoop on default_scene(), driven over loopback by the
     events of tests/test_live.py:19-28 and 24 steady forward steps under
     the launch counters: the wire frames bit for bit an offline card
     FrameLoop's under utils.image.to_srgb_u8, the server's on-card u8 bit
     for bit to_srgb_u8 of its frame, and the median split of a /step
     (render and quantize by CUDA events, the copy to the host, the PNG
     encode, the HTTP round trip); (b) cli.main in process: render and
     orbit (to an APNG, then --resume) at 1920x1088, replay of phase 17's
     stream, pt on the showcase with --bvh (auto: rebin, K5), pt --mega on
     the Cornell box at 512x512, pt with --denoise --aov --tonemap aces
     --gamma 2.2, and instanced at 1920x1088 (K7), each command under the
     launch counters and its every PNG or APNG frame bit for bit the direct
     call of the port's wrapper on the card (the direct calls' kernels by
     torch.profiler's device time beside the ms the command prints); (c)
     python3 -m raytracing_engine_tpu_torch.cli render as a subprocess with
     no --device: exit 0 and the PNG of (b).
 22. the texture features at 1920x1088, 4 bounces, 4 spp, pcg, every
     texture generated here: (a) K6's tangent planes (cluster_kernel<true,
     true>) on the frame's camera rays against a UV icosphere, all twelve
     planes bit for bit with the plain sweep; (b) K7 on a UV base table
     (instanced_uv_kernel<true>): config 5's 6 x 5 grid of a UV icosphere,
     the frame's camera rays, the ten planes (UV and world tangent among
     them) bit for bit; (c) phase 20's showcase with its icosphere
     normal-mapped and mip-chained under tex_filter="trilinear": K4's and
     K5's texture instantiations (pt_tex_kernel<clusters>,
     pt_rebin_tex_kernel) on the band at 1 spp bit for bit with their
     plain versions (trilinear and bilinear), K5's whole frame bit for bit
     K4's, card vs CPU at 64x36; (d) the grid of (b) normal-mapped,
     image-textured and mip-chained: pt_tex_kernel<instances> on a band
     bit for bit, K5 == K4 on the frame; each main path under the launch
     counters (render_pt_mega, render_pt_rebin, render_pt_fast) and timed
     by the profiler, with its bound.
 23. the sampling features: (a) config 4's Cornell box (pcg, R_d) at
     1920x1088 through K4 with adaptive spp (tol 0.05, at least 8 of 64
     passes, the passes table returned) under the launch counters: every
     cell within [8, 64], tol 0 bit for bit the fixed render with a table
     of 64, the band of whole cells at rows 576..639 equal to those rows
     of the frame and, image, table and rays, bit for bit its plain
     version; the cell update (pt_cell_kernel) alone on a seeded state at
     the frame's shapes bit for bit its plain version; K4's adaptive
     launches and the fixed R_d render timed; (b) the showcase through a
     thin lens (aperture 0.15, focused at 7.5) with R_d, 4 spp: K5's frame
     bit for bit K4's, each on rows 536..551 at 2 spp bit for bit its plain
     version, both timed with their bounds; (c) benchmarks/run_all.py's
     quality row at 256x256 (tile (16, 256)): fixed random sampling at 256
     spp against R_d with adaptive tol 0.05 in the same budget, each timed
     and scored by MSE against a 2048-spp render of another seed, the
     adaptive render's mean spp beside.
 24. the light features at 1920x1088, pcg, seed_from_int(1), each main
     path under the launch counters from 0: (a) config 4's Cornell box in
     fog with single scattering (fog_density 0.08, fog_scatter 0.06), 4
     bounces, 4 spp, through K4 pt_lights_kernel<none>, beside the clear
     render; (b) tests/test_light_tree.py's grid of 8 x 8 equal sphere
     lights under an 8-cluster tree, 2 bounces, 4 spp, through K4, the
     frame timed beside power selection on the same scene (pt_kernel<none>);
     (c) tests/test_mesh_lights.py's emissive 320-triangle icosphere over a
     floor, through a ClusterSet, as mesh lights per pass and per lane, 4
     bounces, 4 spp, through K4 pt_lights_kernel<clusters> and K5
     pt_rebin_lights_kernel, K5's frame bit for bit K4's; in (a)-(c) each
     kernel on rows 536..551 at 1 spp bit for bit its plain version, image
     and ray count, and timed with its bound; (d) cli.main: pt --fog on the
     Cornell box through --mega (K4) and through the wavefront, and a scene
     file with mesh_lights through --bvh (a ClusterSet, K5), each PNG bit
     for bit its direct call.
Then a line that sums up phases 4 and 5's image output, one JSON line of
per-kernel results, each number measured in this run
but the bounds, computed from its inputs (K4 once per instantiation, on its
main path's frames: without a mesh at config 2, with clusters at config 3
and with instances at config 5, each 512x512 frame's bound from the work
its plain version counts, config 5's on every 8th row scaled by the
frame's rays, plain_ms those rows'; the material instantiations of K4 and K5 on the
showcase, plain_ms their band's); the card line, and as the last
line {"ok": true, "device": {...}}. Any failure exits
non-zero before the last line; so does a machine without CUDA or a
directory without the repo.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "golden_64.npz"
SMOKE_OUT = ROOT / "smoke_out"  # gitignored
FRAME_PNG = SMOKE_OUT / "chip_smoke_frame.png"
SIZE = (1920, 1088)
K1_SIZE = (1280, 720)  # a second pyramid whose levels are not exact doubles
# K2's hard cases (phase 3): a finest level that K2's 16 x 8 block tile does
# not divide (1000 = 16 x 62.5), and scenes with every object and light slot
# live and with no light
K2_RAGGED = (1000, 504)

# compiled kernel vs plain version: the repo's compiled-vs-reference bound
# (tests_tpu/test_compiled_kernels.py); isolated silhouette pixels may flip
KERNEL_TOL = dict(atol=2e-5, rtol=1e-5)
KERNEL_FRAC = 1e-4
# against the golden artifact: tests/test_parity_jnp_vs_golden.py
DEPTH_TOL = dict(rtol=1e-4, atol=1e-3)
IMAGE_TOL = dict(rtol=1e-3, atol=2e-3)
GOLDEN_FRAC = 1e-3

WALK = 10  # FrameLoop events: W held for 10 frames at dt=0.05
ORBIT = 8  # render_sequence poses
TWO_KERNEL = 2  # render_sequence poses through the two-kernel path
TIMED = 24  # distinct poses for the timings
PLAIN_REPS = 5  # per-kernel plain-version timings (each is a slow loop)
PLAIN_FRAMES = 20  # plain-renderer frames timed (of the TIMED poses)

# the path tracer: BASELINE config 2 (benchmarks/run_all.py:89-117) and
# config 4 (:228-266), seed = key_to_seed(PRNGKey(1))
C2 = dict(width=800, height=608, max_bounces=4)
C2_SPP = 4
C4 = dict(width=256, height=256, max_bounces=4)
C4_POS = (0.0, 0.2, 0.0)
C4_CHUNK = 128
C4_SPP = 1024
C2_FRAMES = 8      # chained config-2 frames per timing round
C2_ROUNDS = 3      # timing rounds; the best is kept, as run_all does
PLAIN_PT_FRAMES = 2
HD = dict(width=1920, height=1088, max_bounces=4)  # BASELINE.json's 1080p axis
BANDS = 4          # config 2 split into this many row bands
# megakernel vs wavefront: tests/test_megakernel.py:37-40
PT_FRAC, PT_MEAN = 0.01, 1e-4
# two sequential float32 sums of the same n non-negative terms differ by at
# most 2 * n * 2^-24 of the total (each add rounds within 2^-24 of a running
# sum that never exceeds it): n = 256 passes
CHUNK_RTOL = 2 * 256 * 2.0 ** -24

# BASELINE config 3 (benchmarks/run_all.py:120-225): the torus knot through
# render_pt_rebin, 2 bounces, 1 spp, NEE, pcg, PRNGKey(1), at 512x512 and
# 1920x1088; camera at the origin (frame z offsets only separate frames)
C3 = dict(width=512, height=512, max_bounces=2)
C3_HD = dict(width=1920, height=1088, max_bounces=2)
C3_LIGHT = (6.0, 4.0, 6.0)  # the light sphere's centre (NEE-style shadow rays)
C3_FRAMES = 8      # chained 512x512 frames per timing round
C3_HD_FRAMES = 4   # chained 1920x1088 frames per timing round
C3_ROUNDS = 3
C3_BAND = (224, 64)  # rows of the band check
C3_CHUNK_RTOL = 2 * 4 * 2.0 ** -24  # the summation bound for n = 4 passes
K6_REPS = 20

# BASELINE config 5 (benchmarks/run_all.py:317-500): 30 instances of a
# 35,200-triangle torus knot, camera at the origin
C5_KNOT = dict(segments=550, sides=32)
C5_GRID = dict(nx=6, ny=5, spacing=4.0, base=(0.0, 14.0, 0.0))
C5_ALBEDO = ((0.8, 0.5, 0.3), (0.4, 0.7, 0.5), (0.5, 0.5, 0.8))
C5_LIGHT = (6.0, 2.0, 8.0)
C5_SIZE = (1920, 1088)
C5_FRAMES = 8        # Phong orbit: yaw = linspace(0, 0.5, 8), hard shadows
C5_SOFT_FRAMES = 4   # soft-shadow orbit
C5_SOFT = dict(light_radius=1.5, shadow_samples=4)
C5_PT = dict(width=512, height=512, max_bounces=2)
C5_PT_FRAMES = 4     # chained path-traced frames per timing round
# the config-5 PT frame is held to the plain megakernel on every 8th row
# (an even sample of its work for the bound): the whole frame's replay took
# 165-268 s of the smoke's 1200 s, rows 224..287 alone 105 s
C5_PT_PLAIN_STRIDE = 8
C5_ROUNDS = 3
C5_BAND = (540, 8)      # Phong rows held to the plain version (30 instances)
# path-traced rows held to the plain K4 and K5 versions: the run of rows
# whose camera rays hit the most instances (the plain two-level sweep costs
# seconds per call, nearly whatever the ray count)
C5_PT_BAND_H = 2
K7_REPS = 10
# a spin kernel of about 1 ms at the H100's clocks: what device_ms's event
# timing enqueues ahead of a launch, so the card waits on no host work
SPIN_CYCLES = 2_000_000
K8_REPS = 20
# node caps that cut walks (phase 13): 7 on the duplicated icosphere; 24 on
# config 3's camera rays, where 1.1% of the rays hit by then against 3.4%
# uncut (the plain traversal on the CPU)
K8_CUT_STEPS = (7, 24)
RAW_FRAMES = 3       # config-3 render_pt_fast frames with the raw BVH per round

# kernel K9 (phase 16): the threefry and pallas streams at config 2
K9_SHAPE = (8, 1088, 1920)
K9_BAND = (517, 64)  # rows of the band check
K9_RAGGED = (3, 17, 33)  # no plane a whole number of the kernel's 256-thread blocks
K9_RAGGED_BAND = (5, 7)
K9_REPS = 50
RNG_FRAMES = 3       # timed render_pt_fast frames per rng mode
RNG_BAND = (304, 64)
# float32 bit patterns of jax.random.uniform(jax.random.PRNGKey(0), K9_SHAPE)
# and of the JAX package's ops/pallas/rng.uniform_planes(-7, *K9_SHAPE) at
# these indices, taken with JAX 0.9.0 on the CPU (jax_threefry_partitionable)
JAX_UNIFORM_KEY0 = {(0, 0, 0): 0x3F729A4E, (0, 0, 1): 0x3F7A8436, (3, 517, 1000): 0x3C458680,
                    (5, 100, 1234): 0x3E984328, (7, 1087, 1919): 0x3E50D0F0}
JAX_PLANES_M7 = {(0, 0, 0): 0x3EE4CB84, (0, 0, 1): 0x3F0468F2, (3, 517, 1000): 0x3E8F6FD0,
                 (5, 100, 1234): 0x3DE93050, (7, 1087, 1919): 0x3F50D1A8}
# the threefry and pallas renders' means against K4's pcg render of the same
# scene: two unbiased estimates of one image at 4 spp, 1.15e-4 and under 5e-5
# apart on the H100; a sanity check only, since every draw of a pass is held
# to the plain version bit for bit
RNG_MEAN_RTOL = 1e-3
C4_DEFAULT_CHUNKS = 2  # progressive_render chunks of 16 passes timed on its default route

# phase 17: the cone-march serving path as the JAX package's cmd_replay
# drives it (cli.py:136-179), at SIZE
REPLAY_EVENTS = 24
REPLAY_MONITOR = (1280, 720)  # the fullscreen toggle's size
REPLAY_CHUNK = 8
VIDEO_FPS = 30
Y4M_LSB = 3  # the y4m round trip's bound, tests/test_replay_video.py:90-105

# phase 18: the denoised temporal path-traced orbit (JAX cli.py:180-268 with
# --temporal, and pt --denoise, :473-492) at C3_HD through config 3's
# ClusterSet: the first ORBIT_POSES poses of a 64-pose orbit around the knot
# (5.6 degrees apart, so that history survives the motion)
ORBIT_POSES = 8
ORBIT_PATH = dict(num_frames=64, radius=8.0, height=0.0, target=(0.0, 8.0, 0.0))
AOV_CHECK = dict(width=160, height=96)  # render_aovs card vs CPU, (a)
AOV_SPP = 2
AO_RADIUS = 1.0
AOV_TOL = dict(atol=1e-5, rtol=1e-5)
FLIP_SHARE = 1e-3  # of the pixels, rounded up to a whole pixel
ORBIT_BAND = (536, 16)  # rows of orbit frame 1 held to the plain K4 at the full width
POST_TOL = dict(atol=2e-5, rtol=2e-5)  # temporal_step and denoise card vs CPU, (b)
STATIC_KEYS = 6    # (c): tests/test_temporal.py:42-61
MEAN_TOL = 1e-5    # of max(1, the pixel's largest frame value)
# (c)'s size, tests/test_temporal.py's. At C3_HD the reprojection maps a
# static pixel back to its own center only to the float32 rounding of its
# coordinate, and the bilinear history lookup mixes in that much of a
# neighbour: that reading is logged, and STATIC_BAND rows of its inputs
# around its worst pixel are written for tests/witness_static_hd.py, which
# runs the JAX package's temporal_step on them
STATIC_SIZE = dict(width=48, height=32, max_bounces=2)
STATIC_BAND = 32
DENOISE_CHECK = dict(width=64, height=64, max_bounces=4)  # (d): tests/test_denoise.py:22-49
DENOISE_POS = (0.0, 0.2, 0.0)
# the linear MSE ratio of the JAX package's denoise on its render_pt_fast at
# rng="pcg" (keys 33 and 99; the AOVs at key 33), taken with JAX 0.9.0 on the
# CPU: the bound of tests/test_denoise.py:49 (< 1.15), which that test meets
# at its threefry stream (1.0159), misses on this one
JAX_PCG_LINEAR_RATIO = 1.1935898
LINEAR_RATIO_RTOL = 1e-3

# K4 at each mesh kind on a band ragged in both directions (509 columns: 31
# of its 16-wide blocks and 13 more; an odd row count), 3 spp, Russian
# roulette from bounce 1, held to the plain version bit for bit: the warp
# form's loops across passes, ended paths and lanes off the image
RAGGED_W = 509
RAGGED_SPP = 3
RAGGED_RR_START = 1
RAGGED_ROWS = 5
K4_REPS = 9

# phase 21: the entry points at SIZE. (a) the live server: the events of
# tests/test_live.py:19-28, then LIVE_STEADY steady forward steps (the split's
# medians are taken over those)
LIVE_EVENTS = [
    dict(move=(0, 1, 0), dt=0.05),
    dict(move=(1, 0, 0), rot=(1, 0), dt=0.05),
    dict(cursor=(12.0, -4.0), dt=0.05),
    dict(move=(0, 0, 1), rot=(0, -1), dt=0.05),
    dict(focus=False),
    dict(move=(0, 1, 0)),
    dict(focus=True),
    dict(move=(0, 1, 0), dt=0.05),
]
LIVE_STEADY = 24
LIVE_STEP = dict(move=(0, 1, 0), dt=0.01)
# (b) the command line
CLI_OUT = SMOKE_OUT / "cli"
CLI_ORBIT = 4           # orbit frames, chunk 2; --resume after frames 0 and 2 exist
CLI_MEGA_SPP = 16       # pt --scene cornell --mega --size 512x512
CLI_DENOISE_SPP = 4     # pt --scene cornell --denoise --aov (256x256, the default size)
CLI_INSTANCED = 2       # instanced frames at SIZE
PORT_KERNELS = {"K1": "pyramid_kernel", "K2": "fused_kernel", "K3": "shade_kernel",
                "K4": "pt_kernel", "K5": "pt_rebin_kernel", "K6": "cluster_kernel",
                "K7": "instanced_kernel", "K8": "traverse_kernel", "K9": "rng_kernel",
                "K4 sampling": "pt_samp_kernel", "K5 sampling": "pt_rebin_samp_kernel",
                "K4 lights": "pt_lights_kernel", "K5 lights": "pt_rebin_lights_kernel"}

# phase 19: the showcase scene (examples/showcase.json) as the JAX package's
# cli.py pt --scene ... --bvh --engine mega renders it (cli.py:312-336):
# loaded onto the card, its 320-triangle smooth icosphere as a ClusterSet,
# 1920x1088, 4 bounces, 4 spp, pcg, seed_from_int(1), the file's camera
SHOWCASE = ROOT / "examples" / "showcase.json"
SHOW = dict(width=1920, height=1088, max_bounces=4)
SHOW_SPP = 4
SHOW_BAND = (536, 16)       # rows held to the plain megakernel at 1 spp
SHOW_FRAMES = 3             # chained whole frames per K4 / K5 timing
SHOW_CHUNK = 2              # progressive_render's chunk (passes)
SHOW_CPU = dict(width=64, height=36, max_bounces=4)   # card vs CPU
SHOW_INV = dict(width=256, height=144, max_bounces=4)  # the zero-feature invariants
SHOW_PNG = SMOKE_OUT / "showcase.png"
# phase 20: the showcase with the env map, rough glass and UV textures
REST_SKY = (64, 128)          # the equirect map's texels (rows, columns), "rows": 32
REST_SUN = (35.0, 200.0, 3.0)  # its sun: elevation and disc radius in degrees, radiance
# the icosphere's PNG texture, texels (rows, columns): 32 rows, the atlas's
# budget (scene.ATLAS_MAX_ROWS, JAX's), refuses a 64 x 64 image
REST_TEX = (32, 64)
REST_PNG = SMOKE_OUT / "showcase_rest.png"
# phase 22: the texture features. The albedo image's mip chain (16 x 64 down
# to 1 x 1: 127 texels wide) fills one 16-row shelf of the atlas and the
# normal map the next, 32 rows in all (scene.ATLAS_MAX_ROWS)
TEX_ALBEDO = (16, 64)
TEX_NORMAL = (16, 32)
TEX_BUMPS = 0.35             # the normal map's tilt: n = normalize(bx, by, 1)
TEX_BASE = dict(subdivisions=3, radius=1.3)  # the instanced UV base mesh (1,280 triangles)
TEX_INST_BAND = (540, 8)     # (d)'s rows held to the plain megakernel at 1 spp
TEX_PNG = SMOKE_OUT / "textures.png"
# phase 23: the sampling features. (a) config 4 at the full width with
# run_all.py's quality-row settings (R_d, adaptive tol 0.05, 8 passes at
# least), a 64-pass budget; (b) the showcase focused on its glass sphere
SAMP = dict(width=1920, height=1088, max_bounces=4)
SAMP_SPP, SAMP_TOL, SAMP_MIN = 64, 0.05, 8
SAMP_BAND = (576, 64)        # (a)'s row of whole 64 x 128 cells held to the plain version
SAMP_CELL_S = 12             # the passes of the cell update's seeded state
SAMP_LENS = dict(aperture=0.15, focus_dist=7.5)
SAMP_SHOW_SPP = 2            # (b)'s band (SHOW_BAND) against the plain versions
QUALITY_SPP, QUALITY_REF_SPP, QUALITY_TILE = 256, 2048, (16, 256)  # run_all.py:268-310
# phase 24: the light features at 1920x1088. (a) config 4's Cornell box in
# fog with single scattering; (b) tests/test_light_tree.py's grid of equal
# sphere lights at n = 8 (64 lights) under an 8-cluster tree, 2 bounces as
# that file renders it; (c) tests/test_mesh_lights.py's emissive icosphere of
# 320 triangles (> TRI_UNROLL_MAX) over a floor, through a ClusterSet, as
# mesh lights per pass and per lane
LIGHTS = dict(width=1920, height=1088, max_bounces=4)
LIGHTS_FOG = dict(fog_density=0.08, fog_scatter=0.06, fog_color=(0.02, 0.02, 0.03))
LIGHTS_SPP = 4
LIGHTS_BAND = (536, 16)      # rows held to the plain versions at 1 spp
LIGHTS_FRAMES = 3            # frames (distinct camera z) a K4 timing
TREE = dict(width=1920, height=1088, max_bounces=2)
TREE_N, TREE_C, TREE_POS = 8, 8, (0.0, 0.0, 1.0)
MESH_LAMP = dict(subdivisions=2, radius=1.0, center=(0.0, 6.0, 2.5))
MESH_POS = (0.0, -1.0, 0.5)
CLI_LIGHTS = (512, 512, 16)  # pt --fog --mega and a mesh_lights scene file: size, spp


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def diverging(got, want, atol, rtol):
    """(max abs error, fraction of elements outside atol + rtol*|want|)."""
    got, want = got.double(), want.double()
    bad = ~torch.isclose(got, want, atol=atol, rtol=rtol)
    return (got - want).abs().max().item(), bad.double().mean().item()


def hold(label: str, got, want, tol, frac_limit):
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite values")
    err, frac = diverging(got, want, **tol)
    log(f"  {label}: max_abs_err={err:.6g} diverging={frac:.6g} (limit {frac_limit:g})")
    if frac > frac_limit:
        raise AssertionError(f"{label}: {frac:.4%} of elements diverge")
    return err


def phase_build():
    from raytracing_engine_tpu_torch.ops.cuda import common

    info = common.build()
    for line in info["log"].splitlines():
        if "ptxas info" in line and ("registers" in line or "entry function" in line) or (
                "spill stores" in line):
            log(f"  {line.strip()}")
    for name in common.LIBRARIES:
        common.library(name)
    built = ", ".join(f"lib{n}.so" for n in info["built"]) or "up to date"
    log(f"build: {built} in {info['seconds']:.2f} s (one nvcc per source, in parallel; "
        f"sm_90a, --fmad=false)")


def hold_k1(cfg, scene, pos, quat) -> float:
    """K1 against the plain pyramid at every level, bit for bit: levels
    0..N-1 and 0..N-2 in one launch each, and each level alone seeded from
    the plain level before; -> the max abs error (0)."""
    from raytracing_engine_tpu_torch.models import conemarch
    from raytracing_engine_tpu_torch.ops.cuda import depth

    plain = conemarch.render_depth_pyramid(cfg, scene, pos, quat)
    n = cfg.level_count
    runs = [(f"0..{n - 1} in one launch", depth.depth_pyramid(cfg, scene, pos, quat)),
            (f"0..{n - 2} in one launch", depth.depth_pyramid(cfg, scene, pos, quat, n - 2))]
    runs.append(("each level alone", tuple(
        depth.depth_level(cfg, i, scene, pos, quat, plain[i - 1] if i else None)
        for i in range(n))))
    err = 0.0
    for label, levels in runs:
        for i, got in enumerate(levels):
            err = max(err, hold(f"K1 {cfg.width}x{cfg.height} levels {label}, level {i} "
                                f"{tuple(got.shape)}", got, plain[i], KERNEL_TOL, KERNEL_FRAC))
            if not torch.equal(got, plain[i]):
                raise AssertionError(f"K1 {label}: level {i} differs from the plain pyramid "
                                     f"on {(got != plain[i]).double().mean().item():.6g} of "
                                     "pixels")
        log(f"  K1 {cfg.width}x{cfg.height} levels {label}: every level bit for bit")
    return err


def phase_kernels(cfg, scene, pos, quat):
    """Each kernel vs its plain version on the same inputs; → max errors."""
    import raytracing_engine_tpu_torch as rtt
    from raytracing_engine_tpu_torch.models import conemarch
    from raytracing_engine_tpu_torch.ops.cuda import fused, shade

    plain = conemarch.render_depth_pyramid(cfg, scene, pos, quat)
    errs = {"depth": max(hold_k1(cfg, scene, pos, quat),
                         hold_k1(rtt.RenderConfig(*K1_SIZE), scene, pos, quat))}
    errs["shade"] = hold_k3("K3 shade", cfg, scene, pos, quat, plain[-1])
    errs["fused"] = hold_k2("K2 fused", cfg, scene, pos, quat, plain[-2])
    return errs


def hold_k3(label, cfg, scene, pos, quat, depth) -> float:
    """K3 on a finished depth against its plain version, bit for bit; -> the
    max abs error (0)."""
    from raytracing_engine_tpu_torch.ops.cuda import shade

    got = shade.shade(cfg, scene, pos, quat, depth)
    want = shade.shade_reference(cfg, scene, pos, quat, depth)
    err = hold(label, got, want, KERNEL_TOL, KERNEL_FRAC)
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: K3 differs from its plain version on "
                             f"{(got != want).double().mean().item():.6g} of elements")
    return err


def hold_k2(label, cfg, scene, pos, quat, prev) -> float:
    """K2 from the plain level before the finest against its plain version,
    bit for bit; -> the max abs error (0)."""
    from raytracing_engine_tpu_torch.ops.cuda import fused

    got = fused.depth_shade_fused(cfg, scene, pos, quat, prev)
    want = fused.fused_reference(cfg, scene, pos, quat, prev)
    err = hold(label, got, want, KERNEL_TOL, KERNEL_FRAC)
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: K2 differs from its plain version on "
                             f"{(got != want).double().mean().item():.6g} of elements")
    return err


def fused_equals_two_kernel(cfg, scene, pos, quat, label=""):
    from raytracing_engine_tpu_torch.models import cuda_renderer

    one = cuda_renderer.render(cfg, scene, pos, quat, fused=True)
    two = cuda_renderer.render(cfg, scene, pos, quat, fused=False)
    if not torch.equal(one, two):
        raise AssertionError(f"fused != two-kernel{label}: "
                             f"{(one != two).double().mean().item():.6g} of elements differ")
    log(f"  fused == two-kernel bit for bit at {cfg.width}x{cfg.height}{label}")


def k2_scenes(device):
    """(label, scene) of K2's hard cases: every one of the 8 object, material
    and light slots live (spheres around the orbit's target, lights around
    them, from a seed), and the default objects with no light."""
    from raytracing_engine_tpu_torch.scene import make_scene
    from raytracing_engine_tpu_torch.scene.default import DEFAULT_MATERIALS, DEFAULT_OBJECTS

    rng = np.random.default_rng(5)
    target = np.array([2.0, 3.0, 1.0])
    objects = [(tuple(target + rng.uniform(-5.0, 5.0, 3)), float(rng.uniform(0.5, 2.5)))
               for _ in range(8)]
    materials = [{"color": tuple(rng.uniform(0.1, 1.0, 3)), "shine": float(rng.uniform(1, 20)),
                  "ambient": 0.05} for _ in range(8)]
    lights = [(tuple(target + rng.uniform(-12.0, 12.0, 3)), tuple(rng.uniform(0.1, 1.0, 3)))
              for _ in range(8)]
    return [("8 spheres, 8 lights", make_scene(objects, materials, lights, device)),
            ("no light", make_scene(DEFAULT_OBJECTS, DEFAULT_MATERIALS, (), device))]


def phase_fused_bitwise(cfg, scene, pos, quat):
    """Fused == two-kernel on the default scene; then K2 and K3 against
    their plain versions and fused == two-kernel on the hard cases: every
    slot live, no light, 1280x720 and a finest level ragged against K2's and
    K3's tiles."""
    import raytracing_engine_tpu_torch as rtt
    from raytracing_engine_tpu_torch.models import conemarch

    fused_equals_two_kernel(cfg, scene, pos, quat)
    cases = [(f"{label}, {cfg.width}x{cfg.height}", cfg, sc)
             for label, sc in k2_scenes(scene.device)]
    for size in (K1_SIZE, K2_RAGGED):
        cases.append((f"default scene, {size[0]}x{size[1]}", rtt.RenderConfig(*size), scene))
    for label, c, sc in cases:
        levels = conemarch.render_depth_pyramid(c, sc, pos, quat)
        hold_k2(f"K2 {label}", c, sc, pos, quat, levels[-2])
        hold_k3(f"K3 {label}", c, sc, pos, quat, levels[-1])
        fused_equals_two_kernel(c, sc, pos, quat, f" ({label})")


def phase_golden(device) -> str:
    """The kernels' 64x64 render against golden_64.npz, within the golden
    tolerances; the port's numpy golden renderer against it, bit for bit;
    -> a summary."""
    import raytracing_engine_tpu_torch as rtt
    from raytracing_engine_tpu_torch.models import cuda_renderer, golden

    z = np.load(GOLDEN)
    cfg = rtt.RenderConfig(width=64, height=64)
    scene = rtt.default_scene(device)
    pos = torch.from_numpy(z["pos"]).to(device)
    quat = torch.from_numpy(z["quat"]).to(device)
    levels = cuda_renderer.render_depth_pyramid(cfg, scene, pos, quat)
    for i, got in enumerate(levels):
        want = torch.from_numpy(z[f"level_{i}"]).to(device)
        hold(f"golden level {i}", got, want, DEPTH_TOL, GOLDEN_FRAC)
    img = cuda_renderer.render(cfg, scene, pos, quat)
    hold("golden image", img, torch.from_numpy(z["image"]).to(device), IMAGE_TOL, GOLDEN_FRAC)
    t0 = time.perf_counter()
    levels = golden.render_depth_pyramid(cfg, scene, pos, quat)
    img = golden.shade(cfg, scene, levels[-1], pos, quat)
    seconds = time.perf_counter() - t0
    for i, level in enumerate(levels):
        if not np.array_equal(level, z[f"level_{i}"]):
            raise AssertionError(f"models/golden.py level {i} differs from golden_64.npz")
    if not np.array_equal(img, z["image"]):
        raise AssertionError("models/golden.py's image differs from golden_64.npz on "
                             f"{(img != z['image']).mean():.6g} of elements")
    msg = (f"models/golden.py renders golden_64.npz bit for bit ({len(levels)} levels and the "
           f"image, {seconds:.2f} s on the host)")
    log(f"  {msg}")
    return msg


def write_frame(img) -> str:
    """Write a host frame through utils.image.write_png to FRAME_PNG and
    read its pixel rows back from the file (filter 0, as encode_png writes
    them) against to_srgb_u8 of the frame; -> a summary."""
    import struct
    import zlib

    from raytracing_engine_tpu_torch.utils import to_srgb_u8, write_png

    FRAME_PNG.parent.mkdir(exist_ok=True)
    write_png(str(FRAME_PNG), img)
    data = FRAME_PNG.read_bytes()
    w, h = struct.unpack(">II", data[16:24])
    idat, pos = b"", 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    want = to_srgb_u8(img)
    if (h, w) != want.shape[:2] or rows[:, 0].any() or not np.array_equal(
            rows[:, 1:].reshape(h, w, 3), want):
        raise AssertionError(f"{FRAME_PNG}: the PNG's pixels differ from to_srgb_u8 of the frame")
    msg = (f"frame 0 of phase 5 written by utils.image.write_png to "
           f"{FRAME_PNG.relative_to(ROOT)} ({w}x{h}, {len(data)} B), read back equal")
    log(f"  {msg}")
    return msg


def nonzero_fraction(img_hwc) -> float:
    return (img_hwc.amax(dim=-1) > 0).double().mean().item()


def phase_main_path(cfg, scene):
    """The user entry points at full size, under the launch counters."""
    from raytracing_engine_tpu_torch.camera import Camera, orbit_path
    from raytracing_engine_tpu_torch.models import conemarch, cuda_renderer
    from raytracing_engine_tpu_torch.ops.cuda import depth, fused, shade
    from raytracing_engine_tpu_torch.runtime import FrameLoop, InputEvent, render_sequence

    device = scene.device
    loop = FrameLoop(cfg, scene)
    frames = []

    def sink(i, img):
        frames.append((img, loop.camera.position.clone(), loop.camera.quat()))

    depth.launches = shade.launches = fused.launches = 0
    loop.run([InputEvent(move=(0, 1, 0), dt=0.05)] * WALK, sink=sink)
    positions, rotations = orbit_path(ORBIT)
    quats = Camera(positions, rotations).quat()
    seq = render_sequence(cfg, scene, positions, quats)
    two = render_sequence(cfg, scene, positions[:TWO_KERNEL], quats[:TWO_KERNEL],
                          fn=functools.partial(cuda_renderer.render, fused=False))
    torch.cuda.synchronize(device)
    counts = {"depth": depth.launches, "fused": fused.launches, "shade": shade.launches}

    end = loop.camera.position.numpy()
    log(f"  FrameLoop: {len(frames)} frames, camera ends at {end.tolist()}")
    if len(frames) != WALK or not np.allclose(end, [0.0, 12.5, 0.0], atol=1e-5):
        raise AssertionError("FrameLoop walk did not end at (0, 12.5, 0)")
    fracs = []
    for i, (img, p, q) in enumerate(frames):
        img = torch.from_numpy(img).to(device)
        want_img = conemarch.render(cfg, scene, p.to(device), q.to(device))
        hold(f"FrameLoop frame {i} vs plain renderer", img, want_img, KERNEL_TOL, KERNEL_FRAC)
        fracs.append(nonzero_fraction(img))
    log(f"  FrameLoop nonzero-pixel fractions: {[round(f, 4) for f in fracs]}")
    png = write_frame(frames[0][0])
    # frames 0-2 see the spheres; from y = 3.75 on the walk has passed them all
    if not 0.0 < fracs[0] < 1.0 or not all(f < 1.0 for f in fracs):
        raise AssertionError("FrameLoop frames are empty or saturated")

    if tuple(seq.shape) != (ORBIT, 3, cfg.height, cfg.width):
        raise AssertionError(f"render_sequence shape {tuple(seq.shape)}")
    if not torch.isfinite(seq).all():
        raise AssertionError("render_sequence: non-finite pixels")
    orbit_fracs = [nonzero_fraction(f.permute(1, 2, 0)) for f in seq]
    log(f"  render_sequence {tuple(seq.shape)}; nonzero-pixel fractions "
        f"{[round(f, 4) for f in orbit_fracs]}")
    if not all(0.0 < f < 1.0 for f in orbit_fracs):
        raise AssertionError("an orbit frame is empty or saturated")
    if not torch.equal(two, seq[:TWO_KERNEL]):
        raise AssertionError("two-kernel render_sequence != fused render_sequence")
    log(f"  render_sequence two-kernel == fused bit for bit ({TWO_KERNEL} poses)")

    n_fused = WALK + ORBIT
    want = {"depth": n_fused + TWO_KERNEL, "fused": n_fused, "shade": TWO_KERNEL}
    log(f"  launches {counts} (expected {want}: 1 K1 (levels 0..{cfg.level_count - 2}) + 1 K2 "
        f"per fused frame x {n_fused}, 1 K1 (levels 0..{cfg.level_count - 1}) + 1 K3 per "
        f"two-kernel frame x {TWO_KERNEL})")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    return counts, png


def cuda_ms(fn, reps: int) -> tuple[float, float]:
    """Mean ms of fn(k), k = 0..reps-1, enqueued back to back: (by CUDA
    events, by the host clock until the last call returned — the enqueue
    time; near the event time, the host is what bounds the loop)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for k in range(reps):
        fn(k)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def phase_timing(cfg, scene, card):
    from raytracing_engine_tpu_torch.camera import Camera, orbit_path
    from raytracing_engine_tpu_torch.models import conemarch, cuda_renderer
    from raytracing_engine_tpu_torch.ops import march
    from raytracing_engine_tpu_torch.ops.cuda import depth, fused, shade
    from raytracing_engine_tpu_torch.utils.timing import (
        RAY_DIR_OPS,
        bound_ms,
        conemarch_ray_count,
        march_ops,
        shade_ops,
    )

    device = scene.device
    n_obj, n_light = int(scene.obj_count), int(scene.light_count)
    positions, rotations = orbit_path(TIMED, radius=16.0)
    quats = Camera(positions, rotations).quat().to(device)
    positions = positions.to(device)
    poses = [(positions[k], quats[k]) for k in range(TIMED)]
    last = cfg.level_count - 1

    def coarse(k):
        """K1: the coarse levels 0..last-1 in one launch -> level last-1."""
        return depth.depth_pyramid(cfg, scene, *poses[k], last - 1)[-1]

    def coarse_plain(k):
        prev = None
        for i in range(last):
            prev = depth.depth_level_reference(cfg, i, scene, *poses[k], prev)
        return prev

    prevs = [coarse(k) for k in range(TIMED)]
    finest = [depth.depth_level(cfg, last, scene, *poses[k], prevs[k]) for k in range(TIMED)]
    torch.cuda.synchronize(device)

    dims = cfg.level_dims  # (w, h) per level
    pixels = cfg.width * cfg.height

    def coarse_work(st):
        """K1 over the coarse levels 0..last-1 in one launch from level 0: it
        writes every level and reads none (a level read back to seed the
        next is the kernel's own traffic, not the function's)."""
        n_bytes = sum(4 * w * h for w, h in dims[:last])
        n_ops = RAY_DIR_OPS * sum(w * h for w, h in dims[:last])
        return n_bytes, n_ops + march_ops(st["march"], n_obj)

    def fused_work(st):
        n_bytes = 4 * dims[last - 1][0] * dims[last - 1][1] + 12 * pixels
        n_ops = (RAY_DIR_OPS * pixels + march_ops(st["march"] + st["shadow"], n_obj)
                 + shade_ops(pixels, n_obj, n_light))
        return n_bytes, n_ops

    def shade_work(st):
        n_ops = (RAY_DIR_OPS * pixels + march_ops(st["shadow"], n_obj)
                 + shade_ops(pixels, n_obj, n_light))
        return 16 * pixels, n_ops

    def timed(label, kernel_fn, plain_fn, plain_reps, work=None, kernel=None):
        """Kernel and plain ms; with `work`, the least time of the kernel's
        work, its operations counted from the march steps the plain version
        took on the same poses (the first plain_reps of them). With `kernel`
        (a kernel launched once a call), ms is that kernel's device time by
        the profiler (device_ms), the event time beside it."""
        kernel_fn(0)  # warm-up
        plain_fn(0)
        ms, host_ms = cuda_ms(kernel_fn, TIMED)
        march.steps.update(march=0, shadow=0)
        plain_ms, _ = cuda_ms(plain_fn, plain_reps)
        out = {"ms": ms, "plain_ms": plain_ms}
        events = ""
        if kernel is not None:
            out["ms"] = device_ms(kernel_fn, TIMED, kernel, setup=lambda k: k % TIMED)
            events = f" device time a call, {ms:.4f} ms by CUDA events"
            ms = out["ms"]
        bound = ""
        if work is not None:
            st = {k: int(v) // plain_reps for k, v in march.steps.items()}
            n_bytes, n_ops = work(st)
            out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, n_ops)
            bound = (f"; bound {out['bound_ms']:.5f} ms by {out['bound_by']} ({n_bytes} B, "
                     f"{n_ops} ops; march steps {st})")
        log(f"  {label}: kernel {ms:.4f} ms{events} (host enqueue {host_ms:.4f} ms), "
            f"plain {plain_ms:.4f} ms (x{plain_ms / ms:.1f}){bound} [{card}]")
        return out

    t = {}
    t["depth"] = timed(f"K1 levels 0..{last - 1} per frame (one launch)", coarse, coarse_plain,
                       PLAIN_REPS, coarse_work, kernel="pyramid_kernel")
    t["fused"] = timed("K2 fused finest level",
                       lambda k: fused.depth_shade_fused(cfg, scene, *poses[k], prevs[k]),
                       lambda k: fused.fused_reference(cfg, scene, *poses[k], prevs[k]),
                       PLAIN_REPS, fused_work, kernel="fused_kernel")
    t["shade"] = timed("K3 shade",
                       lambda k: shade.shade(cfg, scene, *poses[k], finest[k]),
                       lambda k: shade.shade_reference(cfg, scene, *poses[k], finest[k]),
                       PLAIN_REPS, shade_work, kernel="shade_kernel")
    frame = timed(
        f"frame {cfg.width}x{cfg.height}",
        lambda k: cuda_renderer.render(cfg, scene, *poses[k]),
        lambda k: conemarch.render(cfg, scene, *poses[k]), PLAIN_FRAMES)
    frame_ms, plain_frame_ms = frame["ms"], frame["plain_ms"]
    primary, secondary = conemarch_ray_count(cfg, int(scene.light_count))
    rays = primary + secondary
    log(f"  renderer {cfg.width}x{cfg.height}, {TIMED} chained frames with distinct poses: "
        f"kernels {frame_ms:.4f} ms/frame = {rays / frame_ms / 1e3:.2f} Mrays/s; "
        f"plain ({PLAIN_FRAMES} frames) {plain_frame_ms:.4f} ms/frame = "
        f"{rays / plain_frame_ms / 1e3:.2f} Mrays/s "
        f"({primary} primary + {secondary} shadow rays per frame) [{card}]")
    profile_frames(cfg, scene, poses, frame_ms, card)
    return t


def profile_frames(cfg, scene, poses, frame_ms, card):
    """Device time by kernel and pyramid level over the timed poses, from
    torch.profiler; the busy share is that device time over the unprofiled
    event-timed frame."""
    from torch.profiler import ProfilerActivity, profile

    from raytracing_engine_tpu_torch.models import cuda_renderer

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms, _ = cuda_ms(lambda k: cuda_renderer.render(cfg, scene, *poses[k]), TIMED)
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not events:
        log("  profiler: no device events; device time by kernel not measured")
        return
    depth_us = [e.time_range.elapsed_us() for e in events if "pyramid_kernel" in e.name]
    fused_us = [e.time_range.elapsed_us() for e in events if "fused_kernel" in e.name]
    busy_us = sum(e.time_range.elapsed_us() for e in events) / TIMED
    log(f"  profile ({TIMED} frames, profiler on: {prof_ms:.4f} ms/frame): device busy "
        f"{busy_us:.1f} us/frame = {busy_us / 1e3 / frame_ms:.1%} of the unprofiled "
        f"{frame_ms:.4f} ms frame; K2 {sum(fused_us) / max(len(fused_us), 1):.1f} us and K1 "
        f"{sum(depth_us) / max(len(depth_us), 1):.1f} us a launch ({len(fused_us)} and "
        f"{len(depth_us)} launches recorded) [{card}]")


def k4_table_bytes(scene, bvh, pos) -> int:
    """Bytes of the tables K4 reads once for a frame seen from pos: the
    packed scene and, with a mesh, its sweep tables and visit orders."""
    from raytracing_engine_tpu_torch.accel.instancing import InstancedClusters
    from raytracing_engine_tpu_torch.ops.cuda import cluster, pt
    from raytracing_engine_tpu_torch.utils.timing import cluster_table_bytes

    n = 4 * sum(t.numel() for t in pt.pack_pt_scene(pt.kernel_scene(scene, bvh)))
    if bvh is None:
        return n
    frame = pt.frame_view(bvh, pos)
    if isinstance(bvh, InstancedClusters):
        cs, extra = bvh.cs, [bvh.inst_tab, frame.iorder, frame.iorders]
    else:
        cs, extra = bvh, [frame.orders, frame.refs]
    tb = cluster.sweep_tables(cs)
    return n + cluster_table_bytes([tb.sbox, tb.crec, tb.trec, tb.tsmooth, *extra])


def hold_k4_ragged(what, cfg, scene, bvh, pos, quat, seed, row0, rows) -> float:
    """K4 on the ragged band of scene `what` (RAGGED_W columns, rows row0 .. row0 + rows,
    RAGGED_SPP spp, Russian roulette from bounce RAGGED_RR_START) against
    render_pt_mega_reference, bit for bit, through the instantiation of the
    scene's mesh kind; -> the max error (0). A check only: the kernels line
    times K4 on its main paths' frames."""
    import dataclasses

    from raytracing_engine_tpu_torch.ops.cuda import pt

    cfg = dataclasses.replace(cfg, width=RAGGED_W, rr_start=RAGGED_RR_START)
    kw = dict(seed=seed, bvh=bvh, row0=row0, band_h=rows)
    kind = pt.mesh_kind(pt.frame_view(bvh, pos))
    before = dict(pt.mesh_launches)
    got, n_got = pt.render_pt_mega(cfg, scene, pos, quat, RAGGED_SPP, **kw)
    picked = {k: pt.mesh_launches[k] - before[k] for k in before}
    t0 = time.perf_counter()
    want, n_want = pt.render_pt_mega_reference(cfg, scene, pos, quat, RAGGED_SPP, **kw)
    plain_ms = (time.perf_counter() - t0) * 1e3
    same = torch.equal(got, want) and int(n_got) == int(n_want)
    err = (got - want).abs().max().item()
    most = 2 * RAGGED_SPP * RAGGED_W * rows * (cfg.max_bounces + 1)
    label = (f"K4<{kind}> on a ragged band of {what}, {RAGGED_W}x{rows} (rows {row0}..{row0 + rows}"
             f"), {RAGGED_SPP} spp, Russian roulette from bounce {RAGGED_RR_START}")
    log(f"  {label} vs its plain version: bit for bit {same} (max_abs_err={err:.6g}); rays "
        f"{int(n_got)} == {int(n_want)} (at most {most} without an ended path); lit pixels "
        f"{(got.amax(-1) > 0).double().mean().item():.4f}; launches by kind {picked} (plain "
        f"{plain_ms:.1f} ms)")
    if (not same or not torch.isfinite(got).all() or picked[kind] != 1
            or sum(picked.values()) != 1):
        raise AssertionError(f"{label}: differs from its plain version or took another kind")
    return err


def hold_k4_frame(what, cfg, scene, bvh, pos, quat, seed, k4, n4, device, stride=1) -> dict:
    """K4's whole 1-spp frame from pos (k4, n4: render_pt_mega's output) against
    render_pt_mega_reference on the same inputs, or, with stride > 1, its
    every stride-th row (from row stride // 2) against the plain megakernel's
    core on those rows' pixels; the plain run's time and the work it counts
    (instance gates and transforms, box and triangle tests: K4's, as its
    frame equals the plain one; the rows' scaled to the frame by the rays
    traced, an even sample of the frame's rows), from which the frame's
    least time follows; -> the kernels-line numbers but K4's own time."""
    from raytracing_engine_tpu_torch.ops.cuda import cluster, pt
    from raytracing_engine_tpu_torch.ops.cuda import instanced as kinst
    from raytracing_engine_tpu_torch.ops.rng_pcg import pass_seed
    from raytracing_engine_tpu_torch.pathtracer.wavefront import _trace_core
    from raytracing_engine_tpu_torch.utils.timing import bound_ms, instanced_ops, pt_ops

    rows = torch.arange(stride // 2, cfg.height, stride, device=device)
    cluster.work.update(slabs=0, tests=0)
    kinst.work.update(gates=0, transforms=0)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    if stride == 1:
        got, n_got, which = k4, n4, "the frame"
        want, n_want = pt.render_pt_mega_reference(cfg, scene, pos, quat, 1, seed=seed, bvh=bvh)
    else:
        # render_pt_mega_reference's pass 0 on the rows' pixels (x 1 / 1)
        got, n_got, which = k4[rows], None, f"every {stride}th row ({len(rows)} rows)"
        py = rows[:, None].expand(-1, cfg.width)
        px = torch.arange(cfg.width, device=device).expand(len(rows), -1)
        rad, n_want = _trace_core(cfg, pt.kernel_scene(scene, bvh), pos, quat,
                                  pass_seed(seed, 0), pix=(py, px), bvh=pt.frame_view(bvh, pos),
                                  gpass=0, seed_base=seed)
        want = torch.stack(rad, dim=-1) * 1.0
        n_got = n_want  # K4 counts rays a frame; its rows are held bit for bit below
    torch.cuda.synchronize(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    kind = pt.mesh_kind(pt.frame_view(bvh, pos))
    if stride > 1 and not torch.equal(got, want):
        raise AssertionError(f"K4<{kind}> {what}: {which} differ from the plain version")
    err = hold_pt(f"K4<{kind}> {what} {cfg.width}x{cfg.height} {which} vs its plain version "
                  f"(plain {plain_ms / 1e3:.1f} s)", got, n_got, want, n_want)
    scale = int(n4) / int(n_want)
    ops = int((pt_ops(int(n_want), int(scene.sph_count), 0) + instanced_ops(
        kinst.work["gates"], kinst.work["transforms"], cluster.work["slabs"],
        cluster.work["tests"])) * scale)
    n_bytes = 12 * cfg.width * cfg.height + k4_table_bytes(scene, bvh, pos)
    bound = bound_ms(n_bytes, ops)
    log(f"  K4<{kind}> {what} frame bound {bound[0]:.5f} ms by {bound[1]} ({n_bytes} B, {ops} "
        f"ops: {kinst.work['gates']} instance gates, {kinst.work['transforms']} transforms, "
        f"{cluster.work['slabs']} box + {cluster.work['tests']} triangle tests, {int(n_want)} "
        f"rays x {int(scene.sph_count)} spheres, x {scale:.6g}: the frame's rays over those "
        f"of {which})")
    return {"max_abs_err": err, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1]}


def reset_k4():
    """K4's launch counts, in all, by mesh kind and of the material
    instantiation by mesh kind, to 0."""
    from raytracing_engine_tpu_torch.ops.cuda import pt

    pt.launches = 0
    pt.mesh_launches.update(dict.fromkeys(pt.mesh_launches, 0))
    pt.material_launches.update(dict.fromkeys(pt.material_launches, 0))
    pt.tex_launches.update(dict.fromkeys(pt.tex_launches, 0))


def pt_setup(device):
    """(quat, seed, config 2 (cfg, scene, pos), config 4 (cfg, scene, pos))."""
    from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
    from raytracing_engine_tpu_torch.pathtracer import PTConfig, scenes

    quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    c2 = (PTConfig(**C2, rng="pcg"), scenes.material_spheres(device),
          torch.zeros(3, device=device))
    c4 = (PTConfig(**C4, rng="pcg"), scenes.cornell_box(device=device),
          torch.tensor(C4_POS, device=device))
    return quat, seed_from_int(1), c2, c4


def cfg_size(c) -> str:
    return f"{c[0].width}x{c[0].height}"


def hold_pt(label, got, n_got, want, n_want) -> float:
    """Hold a K4 render to its plain version within the megakernel bounds."""
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: shape {tuple(got.shape)} or non-finite pixels")
    d = (got - want).abs().amax(-1).double()
    err, frac, mean = d.max().item(), (d > 1e-3).double().mean().item(), d.mean().item()
    n_got, n_want = int(n_got), int(n_want)
    bitwise = torch.equal(got, want) and n_got == n_want
    log(f"  {label}: max_abs_err={err:.6g} diverging(>1e-3)={frac:.6g} (limit {PT_FRAC}) "
        f"mean_abs={mean:.6g} (limit {PT_MEAN}) rays kernel={n_got} plain={n_want} "
        f"bitwise={bitwise}")
    if frac >= PT_FRAC or mean >= PT_MEAN or abs(n_got - n_want) > max(8, 1e-3 * n_want):
        raise AssertionError(f"{label}: K4 disagrees with its plain version")
    return err


def phase_pt_kernel(quat, seed, c2, c4):
    """K4 vs render_pt_mega_reference on the same inputs, on the card; ->
    the max error, the ragged band's included."""
    from raytracing_engine_tpu_torch.ops.cuda import pt

    errs = []
    for label, (cfg, scene, pos), spp in (
            (f"config 2 {cfg_size(c2)} {C2_SPP} spp", c2, C2_SPP),
            (f"config 4 chunk {cfg_size(c4)} {C4_CHUNK} spp", c4, C4_CHUNK)):
        got, n_got = pt.render_pt_mega(cfg, scene, pos, quat, spp, seed=seed)
        want, n_want = pt.render_pt_mega_reference(cfg, scene, pos, quat, spp, seed=seed)
        errs.append(hold_pt(f"K4 {label}", got, n_got, want, n_want))
    cfg, scene, pos = c2
    errs.append(hold_k4_ragged("config 2", cfg, scene, None, pos, quat, seed,
                               cfg.height // 2 - 3, RAGGED_ROWS))
    return max(errs)


def phase_pt_invariants(quat, seed, c2, c4, device):
    """Furnace, bands, chunking and glass, all through the kernel."""
    from raytracing_engine_tpu_torch.ops.cuda import pt
    from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
    from raytracing_engine_tpu_torch.pathtracer import PTConfig, scenes
    from raytracing_engine_tpu_torch.runtime import ProgressiveState, progressive_render

    pt.launches = 0
    # furnace (tests/test_megakernel.py:43-49): the corners see the enclosure
    cfg = PTConfig(width=32, height=16, max_bounces=3, rng="pcg")
    img, _ = pt.render_pt_mega(cfg, scenes.furnace_scene(0.5, 1.0, device=device),
                               torch.zeros(3, device=device), quat, 32, seed=seed_from_int(13))
    corners = torch.stack([img[0, 0], img[0, -1], img[-1, 0], img[-1, -1]])
    log(f"  furnace 32x16 32 spp: corners {corners.tolist()} (want 1.0, atol 1e-4)")
    if not torch.allclose(corners, torch.ones_like(corners), rtol=0.0, atol=1e-4):
        raise AssertionError("furnace corners are not 1.0")

    # bands: rows row0 .. row0 + band_h of the full render, bit for bit
    cfg, scene, pos = c2
    full, n_full = pt.render_pt_mega(cfg, scene, pos, quat, C2_SPP, seed=seed)
    band_h = cfg.height // BANDS
    bands = [pt.render_pt_mega(cfg, scene, pos, quat, C2_SPP, seed=seed,
                               row0=i * band_h, band_h=band_h) for i in range(BANDS)]
    joined = torch.cat([b[0] for b in bands])
    n_bands = sum(int(b[1]) for b in bands)
    log(f"  bands: {BANDS} x {band_h} rows == full render bit for bit: "
        f"{torch.equal(joined, full)}; rays {n_bands} == {int(n_full)}")
    if not torch.equal(joined, full) or n_bands != int(n_full):
        raise AssertionError("a band render differs from the rows of the full render")

    # chunking: two 128-spp chunks of progressive_render vs one 256-spp call
    cfg, scene, pos = c4
    state = ProgressiveState.start(cfg, pos, quat, key=1, device=device)
    chunks = progressive_render(cfg, scene, state, C4_SPP, passes_per_chunk=C4_CHUNK,
                                render_fn=pt.render_pt_mega)
    state = next(chunks)
    state = next(chunks)
    chunks.close()
    one, _ = pt.render_pt_mega(cfg, scene, pos, quat, 2 * C4_CHUNK, seed=seed)
    want = one * float(2 * C4_CHUNK)
    err = (state.accum - want).abs().max().item()
    ok = torch.allclose(state.accum, want, rtol=CHUNK_RTOL, atol=0.0)
    log(f"  chunking: progressive_render 2 x {C4_CHUNK} spp vs one {2 * C4_CHUNK}-spp "
        f"render (sums): max_abs_err={err:.6g} within rtol {CHUNK_RTOL:.3g}: {ok}; "
        f"bitwise {torch.equal(state.accum, want)}")
    if state.spp_done != 2 * C4_CHUNK or not ok:
        raise AssertionError("progressive_render depends on the chunking")

    # glass Cornell: finite and lit
    glass = scenes.cornell_box(glass=True, device=device)
    img, n = pt.render_pt_mega(cfg, glass, pos, quat, 16, seed=seed)
    mean = img.mean().item()
    log(f"  glass cornell {cfg_size(c4)} 16 spp: finite {bool(torch.isfinite(img).all())}, "
        f"mean {mean:.4f}, rays {int(n)}")
    if not torch.isfinite(img).all() or not mean > 0.0:
        raise AssertionError("glass Cornell render is non-finite or black")

    want_launches = 1 + 1 + BANDS + 2 + 1 + 1
    log(f"  K4 launches {pt.launches} (expected {want_launches}: furnace, full, {BANDS} "
        f"bands, 2 chunks, 256 spp, glass)")
    if pt.launches != want_launches:
        raise AssertionError(f"K4 launches {pt.launches} != {want_launches}")


def profile_pt_frames(c, quat, seed, device, frame_ms, card):
    """Device time of K4 and of everything on the card over C2_FRAMES frames
    (torch.profiler); the busy share is that time over the unprofiled
    event-timed frame."""
    from torch.profiler import ProfilerActivity, profile

    from raytracing_engine_tpu_torch.ops.cuda import pt

    cfg, scene, _ = c
    zs = [torch.tensor([0.0, 0.0, 2e-3 + 1e-4 * k], device=device) for k in range(C2_FRAMES)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms, _ = cuda_ms(lambda k: pt.render_pt_mega(cfg, scene, zs[k], quat, C2_SPP,
                                                         seed=seed), C2_FRAMES)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        log("  profiler: no device events; K4 device time not measured")
        return
    busy_us = sum(e.time_range.elapsed_us() for e in events) / C2_FRAMES
    k4_us = sum(e.time_range.elapsed_us() for e in events if "pt_kernel" in e.name) / C2_FRAMES
    log(f"  profile config 2 ({C2_FRAMES} frames, profiler on: {prof_ms:.4f} ms/frame): K4 "
        f"{k4_us:.1f} us/frame, device busy {busy_us:.1f} us/frame = "
        f"{busy_us / 1e3 / frame_ms:.1%} of the unprofiled {frame_ms:.4f} ms frame [{card}]")


def phase_pt_main(quat, seed, c2, c4, card, device):
    """The path tracer's main path through its entry points (render_pt_mega,
    progressive_render) under the launch counter, timed by CUDA events."""
    from raytracing_engine_tpu_torch.ops.cuda import pt
    from raytracing_engine_tpu_torch.pathtracer import PTConfig, scenes
    from raytracing_engine_tpu_torch.runtime import ProgressiveState, progressive_render
    from raytracing_engine_tpu_torch.utils.timing import bound_ms, pt_ops

    def frames(c, spp, label):
        """Best ms/frame over C2_ROUNDS rounds of C2_FRAMES frames with
        distinct camera z, and the Mrays/s of that round."""
        cfg, scene, _ = c
        zs = [torch.tensor([0.0, 0.0, 1e-3 + 1e-4 * k], device=device) for k in range(C2_FRAMES)]
        pt.render_pt_mega(cfg, scene, zs[0], quat, spp, seed=seed)  # warm-up
        best = None
        for r in range(C2_ROUNDS):
            rays = []
            ms, host_ms = cuda_ms(lambda k: rays.append(
                pt.render_pt_mega(cfg, scene, zs[k], quat, spp, seed=seed)[1]), C2_FRAMES)
            n = int(torch.stack(rays).sum()) // C2_FRAMES
            log(f"  {label} round {r}: {ms:.4f} ms/frame (host enqueue {host_ms:.4f} ms) "
                f"= {n / ms / 1e3:.2f} Mrays/s, {n} rays/frame [{card}]")
            if best is None or ms < best[0]:
                best = (ms, n)
        return best

    reset_k4()
    c2_ms, c2_rays = frames(c2, C2_SPP, f"config 2 {cfg_size(c2)} {C2_SPP} spp")
    profile_pt_frames(c2, quat, seed, device, c2_ms, card)

    cfg, scene, pos = c4
    rays = []

    def counted(*args, **kwargs):
        img, n = pt.render_pt_mega(*args, **kwargs)
        rays.append(n)
        return img, n

    state = ProgressiveState.start(cfg, pos, quat, key=1, device=device)
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for state in progressive_render(cfg, scene, state, C4_SPP, passes_per_chunk=C4_CHUNK,
                                    render_fn=counted):
        pass
    end.record()
    end.synchronize()
    c4_s = start.elapsed_time(end) / 1e3
    host_s = time.perf_counter() - t0
    c4_rays = int(torch.stack(rays).sum())
    if state.spp_done != C4_SPP or not torch.isfinite(state.accum).all():
        raise AssertionError("config 4 progressive render incomplete or non-finite")
    c4_bytes = (C4_SPP // C4_CHUNK) * 12 * cfg.width * cfg.height
    c4_bound = bound_ms(c4_bytes, pt_ops(c4_rays, int(scene.sph_count), int(scene.tri_count)))
    log(f"  config 4 {cfg_size(c4)} {C4_SPP} spp via progressive_render ({C4_SPP // C4_CHUNK} "
        f"chunks of {C4_CHUNK}): {c4_s:.4f} s by CUDA events ({host_s:.4f} s host) = "
        f"{C4_SPP / c4_s:.1f} spp/s = {c4_rays / c4_s / 1e6:.2f} Mrays/s, {c4_rays} rays; "
        f"bound {c4_bound[0]:.4f} ms by {c4_bound[1]}; image mean "
        f"{state.accum.mean().item() / C4_SPP:.4f} [{card}]")

    hd = (PTConfig(**HD, rng="pcg"), scenes.material_spheres(device), None)
    hd_ms, hd_rays = frames(hd, C2_SPP, f"material_spheres {cfg_size(hd)} {C2_SPP} spp")
    launches, by_kind = pt.launches, dict(pt.mesh_launches)

    cfg, scene, pos = c2
    pt.render_pt_mega_reference(cfg, scene, pos, quat, C2_SPP, seed=seed)  # warm-up
    plain_ms, _ = cuda_ms(lambda k: pt.render_pt_mega_reference(
        cfg, scene, pos, quat, C2_SPP, seed=seed), PLAIN_PT_FRAMES)
    table_bytes = 4 * sum(t.numel() for t in pt.pack_pt_scene(scene))
    c2_bytes = 12 * cfg.width * cfg.height + table_bytes
    c2_bound = bound_ms(c2_bytes, pt_ops(c2_rays, int(scene.sph_count), int(scene.tri_count)))
    log(f"  plain version config 2: {plain_ms:.4f} ms/frame (x{plain_ms / c2_ms:.1f} the "
        f"kernel) [{card}]")
    zs = [torch.tensor([0.0, 0.0, 1e-3 + 1e-4 * k], device=device) for k in range(C2_FRAMES)]
    k4_ms = device_ms(lambda k: pt.render_pt_mega(cfg, scene, zs[k % C2_FRAMES], quat, C2_SPP,
                                                  seed=seed), K4_REPS, "pt_kernel",
                      setup=lambda k: k)
    log(f"  K4 config 2 bound {c2_bound[0]:.5f} ms by {c2_bound[1]} ({c2_bytes} B, "
        f"{pt_ops(c2_rays, int(scene.sph_count), int(scene.tri_count))} ops for {c2_rays} "
        f"rays); K4 {k4_ms:.4f} ms of device time a frame (the profiler's), at "
        f"{c2_bound[0] / k4_ms:.2%} of it [{card}]")
    hd_cfg, hd_scene, _ = hd
    hd_bytes = 12 * hd_cfg.width * hd_cfg.height + table_bytes
    hd_ops = pt_ops(hd_rays, int(hd_scene.sph_count), int(hd_scene.tri_count))
    hd_bound = bound_ms(hd_bytes, hd_ops)
    log(f"  K4 {cfg_size(hd)} {C2_SPP} spp bound {hd_bound[0]:.5f} ms by {hd_bound[1]} "
        f"({hd_bytes} B, {hd_ops} ops for {hd_rays} rays, as the plain version counts them: "
        f"they are K4's bit for bit); the frame at {hd_bound[0] / hd_ms:.2%} of it [{card}]")

    n_c2 = 1 + (C2_ROUNDS + 1) * C2_FRAMES  # warm-up, timed rounds, profiled frames
    want = n_c2 + C4_SPP // C4_CHUNK + 1 + C2_ROUNDS * C2_FRAMES
    log(f"  K4 launches on the main path {launches} (expected {want}: {n_c2} config-2 frames, "
        f"{C4_SPP // C4_CHUNK} config-4 chunks, {1 + C2_ROUNDS * C2_FRAMES} 1080p frames)")
    if launches != want or by_kind["none"] != launches:
        raise AssertionError(f"K4 launches {launches} ({by_kind} by mesh kind) != {want}")
    return {"launches": launches, "ms": k4_ms, "plain_ms": plain_ms,
            "bound_ms": c2_bound[0], "bound_by": c2_bound[1]}


def c3_setup(device):
    """Config 3: (mesh, ClusterSet, scene, cfg, cluster build seconds), as
    benchmarks/run_all.py:120-148 builds it (tri_mats 0, SAH, subtree)."""
    from raytracing_engine_tpu_torch.accel import build_clusters, torus_knot
    from raytracing_engine_tpu_torch.pathtracer import DIFFUSE, PTConfig, build_pt_scene

    mesh = torus_knot(segments=1100, sides=32, center=(0.0, 8.0, 0.0))
    mats_t = np.zeros(mesh.shape[0], np.int32)
    t0 = time.perf_counter()
    cs = build_clusters(mesh, tri_mats=mats_t, device=device)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    mats = [
        {"albedo": (0.7, 0.6, 0.4), "kind": DIFFUSE},
        {"albedo": (0, 0, 0), "emission": (10.0,) * 3, "kind": DIFFUSE},
        {"albedo": (0.5, 0.5, 0.6), "kind": DIFFUSE},
    ]
    scene = build_pt_scene(spheres=[((6.0, 4.0, 6.0), 1.5, 1), ((0.0, 8.0, -103.0), 100.0, 2)],
                           triangles=mesh, tri_mats=mats_t, materials=mats, device=device)
    return mesh, cs, scene, PTConfig(**C3, rng="pcg"), build_s


def hold_sweep(label, got, want, kernel="K6"):
    """A sweep kernel (K6, K7, K8) against its plain version: -> the max abs
    error of t and attributes where both hit; raises unless every output is
    equal bit for bit."""
    slot_diff = (got[1] != want[1]).double().mean().item()
    both = (got[1] >= 0) & (want[1] >= 0)
    err = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        if k != 1 and both.any():
            err = max(err, (g[both] - w[both]).abs().max().item())
    bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
    log(f"  {label}: hits {(got[1] >= 0).double().mean().item():.4f}, max_abs_err={err:.6g} "
        f"slots differ on {slot_diff:.6g} of rays, bitwise={bitwise}")
    if not bitwise:
        raise AssertionError(f"{label}: {kernel} differs from its plain version")
    return err


def axis_parallel_rays(device, n=64):
    """An n x n grid against icosphere(2) at (0, 5, 0): axis-parallel rays
    (exact +-0 direction components, some running in a box face's plane)
    and, in the last quarter of the rows, rays parked at 1e18."""
    rng = np.random.default_rng(0)
    center = np.array([0.0, 5.0, 0.0], np.float32)
    o = np.zeros((3, n * n), np.float32)
    d = np.zeros((3, n * n), np.float32)
    for k in range(n * n):
        axis, sign = k % 3, (1.0 if (k // 3) % 2 == 0 else -1.0)
        off = rng.uniform(-1.4, 1.4, 3).astype(np.float32)
        off[axis] = -3.0 * sign
        if k % 5 == 0:
            off[(axis + 1) % 3] = 0.0
        o[:, k] = center + off
        d[:, k] = np.where(np.arange(3) == axis, sign, -0.0 if k % 2 else 0.0)
    park = slice(3 * n * n // 4, None)
    o[:, park] = 1e18
    d[:, park] = np.float32(0.5773502691896258)
    to = lambda a: tuple(torch.from_numpy(x.reshape(n, n)).to(device) for x in a)  # noqa: E731
    return to(o), to(d)


def c3_rays(c3, quat, seed, device):
    """Config 3's rays at 512x512 (phases 10 and 13): the camera rays of pass
    0, the bounce-1 rays of one K5 pass over the ClusterSet, and the NEE-style
    shadow directions from their origins toward the light sphere's centre
    with their distances: (o0, d0, o1, d1, wi, dist)."""
    from raytracing_engine_tpu_torch.ops.cuda import pt
    from raytracing_engine_tpu_torch.ops.rng_pcg import pass_seed, uniform_pcg
    from raytracing_engine_tpu_torch.pathtracer.wavefront import _camera_rays

    _, cs, scene, cfg, _ = c3
    pos = torch.zeros(3, device=device)
    u = uniform_pcg(pass_seed(seed, 0), 0, 2, cfg.height, cfg.width, device=device)
    o0, d0 = _camera_rays(cfg, pos, quat, u[0], u[1])
    o0, d0 = tuple(x.contiguous() for x in o0), tuple(x.contiguous() for x in d0)
    _, _, run = pt.rebin_bounce_launcher(cfg, scene, pos, quat, seed, cs)
    state, _ = run(0, None, 0)
    o1 = tuple(state[a].clone() for a in range(3))
    d1 = tuple(state[3 + a].clone() for a in range(3))
    light = torch.tensor(C3_LIGHT, device=device)
    to_l = tuple(light[a] - o1[a] for a in range(3))
    dist = torch.sqrt(to_l[0] * to_l[0] + to_l[1] * to_l[1] + to_l[2] * to_l[2])
    wi = tuple(c / dist for c in to_l)
    return o0, d0, o1, d1, wi, dist


def phase_cluster_kernel(c3, quat, seed, device, card):
    """K6 against its plain version on the card, and K6 timed."""
    from raytracing_engine_tpu_torch.accel import build_clusters, icosphere
    from raytracing_engine_tpu_torch.ops.cuda import cluster
    from raytracing_engine_tpu_torch.utils.timing import (
        bound_ms,
        cluster_table_bytes,
        k6_bytes,
        sweep_ops,
    )

    mesh, cs, scene, cfg, build_s = c3
    log(f"  config-3 ClusterSet: {mesh.shape[0]} triangles -> {cs.num_clusters} clusters, "
        f"{cs.num_super} super clusters, {cs.padded_tris} slots; BVH builder {cs.builder}; "
        f"host build {build_s:.3f} s")
    pos = torch.zeros(3, device=device)
    fc = cluster.FrameClusters.at(cs, pos)
    orders = dict(order=fc.orders[0], orders=fc.orders, refs=fc.refs)
    o0, d0, o1, d1, wi, dist = c3_rays(c3, quat, seed, device)
    small = build_clusters(icosphere(subdivisions=2, radius=1.2, center=(0.0, 5.0, 0.0)),
                           device=device)
    oa, da = axis_parallel_rays(device)
    inf = float("inf")
    cases = [
        ("camera rays 512x512, closest + attrs", cs, o0, d0, inf, dict(attrs=True, **orders)),
        ("bounce-1 rays, closest + attrs", cs, o1, d1, inf, dict(attrs=True, **orders)),
        ("bounce-1 NEE shadow rays, any hit", cs, o1, wi, dist * 0.999,
         dict(any_hit=True, order=fc.orders[0])),
        (f"axis-parallel + parked rays vs a padded set ({small.num_clusters} clusters, "
         f"{int(torch.isnan(small.boxes[:, 0]).sum())} all-NaN), closest + attrs", small, oa, da,
         inf, dict(attrs=True)),
        ("axis-parallel + parked rays vs the padded set, any hit t_max=2", small, oa, da, 2.0,
         dict(any_hit=True)),
    ]
    err = 0.0
    plain = {}
    for k, (label, cset, o, d, t_max, kw) in enumerate(cases):
        got = cluster.cluster_intersect(cset, o, d, t_max, **kw)
        torch.cuda.synchronize(device)
        cluster.work.update(slabs=0, tests=0)
        t0 = time.perf_counter()
        want = cluster.cluster_intersect_reference(cset, o, d, t_max, **kw)
        torch.cuda.synchronize(device)
        if k == 0:
            plain = dict(plain_ms=(time.perf_counter() - t0) * 1e3, **cluster.work)
        err = max(err, hold_sweep(label, got, want))

    # K6 alone: the camera sweep of render_pt_fast(bvh=cs) (closest, no attrs)
    kw = dict(cases[0][5], attrs=False)
    cluster.cluster_intersect(cs, o0, d0, inf, **kw)  # warm-up
    event_ms, host_ms = cuda_ms(lambda k: cluster.cluster_intersect(cs, o0, d0, inf, **kw),
                                K6_REPS)
    ms = device_ms(lambda _: cluster.cluster_intersect(cs, o0, d0, inf, **kw), K6_REPS,
                   "cluster_kernel")
    tb = cluster.sweep_tables(cs)
    n = cfg.width * cfg.height
    n_bytes = k6_bytes(n, False, cluster_table_bytes(
        [tb.sbox, tb.crec, tb.trec, tb.tsmooth, fc.orders, fc.refs]))
    n_ops = sweep_ops(plain["slabs"], plain["tests"])
    bound = bound_ms(n_bytes, n_ops)
    log(f"  K6 camera sweep 512x512 (closest): kernel {ms:.4f} ms device time, {event_ms:.4f} ms "
        f"by CUDA events (host enqueue {host_ms:.4f} ms), plain {plain['plain_ms']:.1f} ms; "
        f"{plain['slabs']} box + {plain['tests']} triangle tests -> bound {bound[0]:.5f} ms by "
        f"{bound[1]} ({n_bytes} B, {n_ops} ops), "
        f"kernel at {bound[0] / ms:.2%} of it [{card}]")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain["plain_ms"],
            "bound_ms": bound[0], "bound_by": bound[1]}


# --- the warp sweep's hard rays (phases 11 and 14) ----------------------------

def np_rays(o, d, device):
    """(3, n) numpy origins and directions -> plane tuples on the card."""
    def to(a):
        return tuple(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device) for x in a)

    return to(o), to(d)


def unit(v):
    return (v / np.linalg.norm(v, axis=0, keepdims=True)).astype(np.float32)


def vertex_rays(tris, n, rng, reach=0.7):
    """Rays aimed at the shared vertices and edge midpoints of a mesh (T, 3,
    3): each from a point `reach` out on the side of its face's normal, so
    it meets the mesh where two or more triangles meet and rounding decides
    which one holds the hit. -> (o, d), (3, n) each."""
    pick = rng.choice(tris.shape[0], n, replace=tris.shape[0] < n)
    t = tris[pick].astype(np.float64)
    k = rng.integers(0, 3, n)
    a, b = t[np.arange(n), k], t[np.arange(n), (k + 1) % 3]
    target = np.where((np.arange(n) % 2 == 0)[:, None], a, 0.5 * (a + b))
    nrm = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-30)
    jitter = rng.normal(0.0, 0.6, (n, 3))
    off = nrm + jitter - np.minimum((jitter * nrm).sum(1, keepdims=True), 0.0) * nrm
    o = target + reach * off / np.linalg.norm(off, axis=1, keepdims=True)
    return o.T.astype(np.float32), unit((target - o).T)


def grazing_rays(boxes, n, rng):
    """Rays that graze boxes (rows [min(3), max(3), ...], NaN rows skipped):
    along a face in its plane, along an edge, through a corner, and nearly
    parallel to a face. -> (o, d), (3, n) each."""
    live = boxes[~np.isnan(boxes[:, 0])][:, :6].astype(np.float32)
    o, d = np.zeros((3, n), np.float32), np.zeros((3, n), np.float32)
    for i in range(n):
        b = live[rng.integers(live.shape[0])]
        mn, mx = b[:3], b[3:]
        mid = 0.5 * (mn + mx)
        kind, ax = i % 4, (i // 4) % 3
        a1, a2 = (ax + 1) % 3, (ax + 2) % 3
        if kind == 0:      # in the plane of the face x_ax = min, along a1
            o[:, i] = mid
            o[ax, i], o[a1, i] = mn[ax], mn[a1] - 0.5
            d[a1, i] = 1.0
        elif kind == 1:    # along the edge x_ax = max, x_a1 = max, along a2
            o[:, i] = mx
            o[a2, i] = mx[a2] + 0.5
            d[a2, i] = -1.0
        elif kind == 2:    # through the min corner
            d[:, i] = unit(rng.uniform(0.2, 1.0, (3, 1)))[:, 0]
            o[:, i] = mn - 0.5 * d[:, i]
        else:              # nearly parallel to the face x_ax = max
            o[:, i] = mid
            o[ax, i], o[a1, i] = mx[ax], mn[a1] - 0.5
            d[a1, i], d[ax, i] = 1.0, (-1e-6 if i % 8 < 4 else 1e-6)
            d[:, i] = unit(d[:, i:i + 1])[:, 0]
    return o, d


def mixed_row_rays(refs, center, n, rng):
    """Rays whose origins sit by the visit-order references in turn (lane j
    by reference j mod K), so the lanes of one warp pick different order
    rows; aimed at `center` with a spread. -> (o, d), (3, n) each."""
    k = np.arange(n) % refs.shape[0]
    o = refs[k].T + rng.normal(0.0, 0.05, (3, n))
    target = center[:, None] + rng.normal(0.0, 1.5, (3, n))
    return o.astype(np.float32), unit(target - o)


def axis_parallel_np(center, n, rng):
    """axis_parallel_rays' pattern around `center` as (3, n) arrays: exact
    +-0 direction components, some in a box face's plane, the last quarter
    parked at 1e18."""
    o, d = np.zeros((3, n), np.float32), np.zeros((3, n), np.float32)
    for k in range(n):
        axis, sign = k % 3, (1.0 if (k // 3) % 2 == 0 else -1.0)
        off = rng.uniform(-1.4, 1.4, 3).astype(np.float32)
        off[axis] = -3.0 * sign
        if k % 5 == 0:
            off[(axis + 1) % 3] = 0.0
        o[:, k] = center + off
        d[:, k] = np.where(np.arange(3) == axis, sign, -0.0 if k % 2 else 0.0)
    o[:, 3 * n // 4:] = 1e18
    d[:, 3 * n // 4:] = np.float32(0.5773502691896258)
    return o, d


def dup_icosphere():
    """tests/test_torch_cluster.py::test_batched_selection_equals_sequential_scan's
    set: icosphere(1) at (0, 5, 0), every triangle twice, so every hit is an
    exact tie and the first one visited must win."""
    from raytracing_engine_tpu_torch.accel import icosphere

    tris = icosphere(subdivisions=1, radius=1.2, center=(0.0, 5.0, 0.0))
    return np.concatenate([tris, tris])


def dup_scene(device, tris=None):
    """A path-tracing scene of a light sphere, a ground sphere and, given,
    the diffuse triangles `tris` (e.g. dup_icosphere())."""
    from raytracing_engine_tpu_torch.pathtracer import DIFFUSE, build_pt_scene

    mesh = {} if tris is None else dict(triangles=tris, tri_mats=np.zeros(len(tris), np.int32))
    return build_pt_scene(
        spheres=[((2.5, 7.5, 2.5), 0.6, 1), ((0.0, 5.0, -103.0), 100.0, 2)], device=device,
        materials=[{"albedo": (0.7, 0.6, 0.4), "kind": DIFFUSE},
                   {"albedo": (0, 0, 0), "emission": (10.0,) * 3, "kind": DIFFUSE},
                   {"albedo": (0.5, 0.5, 0.6), "kind": DIFFUSE}], **mesh)


def ray_state(o, d):
    """A K5 state of rays (o, d) after a bounce: throughput 1, radiance 0,
    alive, no NEE before, pixel ids 0..n-1 on row 0 (they key the draws);
    a ray whose origin is parked (|o.x| >= 1e17) is a dead one, as a bounce
    leaves it: direction (1, 1, 1)/sqrt(3), throughput 0, not alive."""
    n = o[0].numel()
    st = torch.zeros((17, n), dtype=torch.float32, device=o[0].device)
    for a in range(3):
        st[a], st[3 + a] = o[a], d[a]
    st[6:9] = 1.0
    st[12] = 1.0
    st[15] = torch.arange(n, dtype=torch.float32, device=o[0].device)
    dead = o[0].abs() >= 1e17
    st[3:6, dead] = float(np.float32(0.5773502691896258))
    st[6:9, dead] = 0.0
    st[12, dead] = 0.0
    return st


def same_state(got, want) -> bool:
    """K5's state against its plain version's, bit for bit, except planes
    13-14 (prev_did_nee, prev_pdf) of the rays parked after the bounce: read
    by no later launch, regroup or scatter, zeroed by the kernel's park and
    left by the plain version at what it computed on every lane
    (pathtracer/wavefront.py _bounce)."""
    live = want[0].abs() < 1e17
    return (torch.equal(got[:13], want[:13]) and torch.equal(got[15:], want[15:])
            and torch.equal(got[13:15, live], want[13:15, live]))


def hold_k5_rays(label, scene, bvh, o, d, seed, quat):
    """Bounce 1 of K5 on a state of the rays (o, d) against its plain
    version (the wavefront core on the same state, as
    render_pt_rebin_reference runs it), bit for bit."""
    from raytracing_engine_tpu_torch.ops.cuda import pt
    from raytracing_engine_tpu_torch.ops.rng_pcg import pass_seed
    from raytracing_engine_tpu_torch.pathtracer import PTConfig
    from raytracing_engine_tpu_torch.pathtracer.wavefront import (
        STATE_PLANES,
        _trace_core,
        pack_state,
        unpack_state,
    )

    n = o[0].numel()
    cfg = PTConfig(width=n, height=1, max_bounces=2, rng="pcg")
    pos = torch.zeros(3, device=o[0].device)
    state = ray_state(o, d)
    t0 = time.perf_counter()
    st = _trace_core(cfg, pt.kernel_scene(scene, bvh), pos, quat, pass_seed(seed, 0),
                     state_in=unpack_state(state), bvh=pt.frame_view(bvh, pos), bounce_lo=1,
                     bounce_hi=1, emit_state=True)
    want, n_want = pack_state(st).reshape(STATE_PLANES, n), int(st["nrays"])
    plain_s = time.perf_counter() - t0
    _, _, run = pt.rebin_bounce_launcher(cfg, scene, pos, quat, seed, bvh)
    got, n_got = run(1, state.clone(), 0)
    torch.cuda.synchronize()
    same = same_state(got, want) and int(n_got) == n_want
    live = int((state[0].abs() < 1e17).sum())
    log(f"  K5 {label}: {n} rays ({live} live, last warp {n % 32 or 32} lanes), bounce 1 vs "
        f"its plain version bit for bit (the state; planes 13-14 of the "
        f"{int((want[0].abs() >= 1e17).sum())} rays it parks aside): {same}; rays "
        f"{n_want}, alive after it {(want[12] > 0).double().mean().item():.3f}; plain "
        f"{plain_s:.1f} s")
    if not same:
        raise AssertionError(f"K5 {label}: differs from its plain version")


def hold_k7_rays(label, inst_tab, cs, o, d, origin):
    """K7 against its plain version on the rays (o, d), closest hit with
    normals and any hit (t_max 2.5), bit for bit; -> the max abs error."""
    from raytracing_engine_tpu_torch.ops.cuda import instanced as kinst

    err = 0.0
    n = o[0].numel()
    for what, mode in (("closest + normal", dict(attrs=True)),
                       ("any hit", dict(any_hit=True, t_max=2.5))):
        want = kinst.instanced_cluster_intersect_reference(inst_tab, cs, o, d, origin=origin,
                                                           **mode)
        got = kinst.instanced_cluster_intersect(inst_tab, cs, o, d, origin=origin, **mode)
        torch.cuda.synchronize()
        err = max(err, hold_sweep(f"K7 {label}, {n} rays (last warp {n % 32 or 32} lanes), "
                                  f"{what}", got, want, "K7"))
    return err


def instance_world(inst_tab, pts):
    """(P, 3) object-space points -> (N, P, 3) world points of every instance
    of a pack_instances table: R (s p) + trans, R = inv_rot^T."""
    tab = inst_tab.cpu().numpy().astype(np.float64)
    inv = tab[:, 0:9].reshape(-1, 3, 3)
    return (np.einsum("nji,pj->npi", inv, pts.astype(np.float64)) * tab[:, None, 12:13]
            + tab[:, None, 9:12])


def c3_hard_rays(c3, device):
    """The rays where the warp sweep can break, against config 3's set and
    the duplicated icosphere: [(label, scene, ClusterSet, (o, d) (3, n)
    numpy arrays)], every set ending in a ragged warp (n % 32 of 13, 7, 31,
    5 and 1)."""
    from raytracing_engine_tpu_torch.accel import build_clusters
    from raytracing_engine_tpu_torch.ops.cuda import cluster

    mesh, cs, scene, _, _ = c3
    rng = np.random.default_rng(7)
    tris = dup_icosphere()
    dscene = dup_scene(device, tris)
    dcs = build_clusters(tris, tri_mats=np.zeros(len(tris), np.int32), device=device)
    refs = cluster.FrameClusters.at(cs, torch.zeros(3, device=device)).refs.cpu().numpy()
    knot_center = np.array([0.0, 8.0, 0.0], np.float32)
    sets = [
        ("config 3, knot vertices and edge midpoints", scene, cs,
         vertex_rays(mesh, 32 * 40 + 13, rng)),
        ("config 3, grazing cluster boxes", scene, cs,
         grazing_rays(cs.boxes.cpu().numpy(), 32 * 24 + 7, rng)),
        (f"config 3, lanes by the {refs.shape[0]} order references in turn (mixed rows)", scene,
         cs, mixed_row_rays(refs, knot_center, 32 * 24 + 31, rng)),
        ("duplicated icosphere (every hit a tie), vertices and edges", dscene, dcs,
         vertex_rays(dup_icosphere(), 32 * 12 + 5, rng)),
        ("duplicated icosphere, axis-parallel and parked", dscene, dcs,
         axis_parallel_np(np.array([0.0, 5.0, 0.0], np.float32), 32 * 12 + 1, rng)),
    ]
    return sets


def phase_c3_warp_rays(c3, quat, seed, device):
    """K5's warp sweep (phase 11) and K6's on the rays where they can break
    (c3_hard_rays), against their plain versions bit for bit: K5 one bounce
    on a state of them; K6 closest hit with attributes and the frame's
    visit orders (config 3's FrameClusters at the origin; the icosphere's
    own), then any hit (t_max 2.5, the first order row); -> K6's max abs
    error."""
    from raytracing_engine_tpu_torch.ops.cuda import cluster

    err = 0.0
    origin = torch.zeros(3, device=device)
    for label, sc, cset, (o, d) in c3_hard_rays(c3, device):
        o, d = np_rays(o, d, device)
        hold_k5_rays(label, sc, cset, o, d, seed, quat)
        fc = cluster.FrameClusters.at(cset, origin)
        n = o[0].numel()
        for what, t_max, kw in (
                ("closest + attrs", float("inf"),
                 dict(attrs=True, order=fc.orders[0], orders=fc.orders, refs=fc.refs)),
                ("any hit", 2.5, dict(any_hit=True, order=fc.orders[0]))):
            got = cluster.cluster_intersect(cset, o, d, t_max, **kw)
            want = cluster.cluster_intersect_reference(cset, o, d, t_max, **kw)
            torch.cuda.synchronize(device)
            err = max(err, hold_sweep(f"K6 {label}, {n} rays (last warp {n % 32 or 32} "
                                      f"lanes), {what}", got, want))
    return err


def phase_c5_warp_rays(c5, quat, seed, device):
    """K7's and K5's warp sweeps with instances (phase 14) on the rays where
    they can break, against their plain versions bit for bit; -> K7's max
    error."""
    from raytracing_engine_tpu_torch.accel import (
        build_bvh,
        build_clusters,
        make_instanced_clusters,
        make_instances,
    )

    rng = np.random.default_rng(11)
    cs, ic, mesh = c5["cs"], c5["ic"], c5["mesh"]
    # the duplicated icosphere as two instances, one rotated and scaled
    dup = dup_icosphere() - np.array([0.0, 5.0, 0.0], np.float32)
    rot = np.array([[np.cos(0.7), -np.sin(0.7), 0.0], [np.sin(0.7), np.cos(0.7), 0.0],
                    [0.0, 0.0, 1.0]], np.float32)
    pair = make_instances(build_bvh(dup, device=device),
                          [(np.eye(3, dtype=np.float32), (0.0, 5.0, 0.0), 1.0),
                           (rot, (1.4, 5.4, 0.3), 0.8)], device=device)
    dcs = build_clusters(dup, device=device)
    dic = make_instanced_clusters(pair, dcs, device=device)
    # world vertices of a few config-5 instances, and of both duplicates
    pick = rng.choice(mesh.shape[0], 256, replace=False)
    world = instance_world(ic.inst_tab, mesh[pick].reshape(-1, 3)).reshape(-1, 256, 3, 3)
    knot_w = world[rng.integers(0, world.shape[0], 256), np.arange(256)]  # one instance each
    dup_w = instance_world(dic.inst_tab, dup.reshape(-1, 3)).reshape(-1, 3, 3)
    err = 0.0
    for label, tab, cset, (o, d) in (
            ("config 5, instance-space knot vertices and edges in the world", ic.inst_tab, cs,
             vertex_rays(knot_w, 32 * 20 + 9, rng)),
            ("config 5, grazing the instances' world boxes", ic.inst_tab, cs,
             grazing_rays(ic.inst_tab[:, 13:19].cpu().numpy(), 32 * 8 + 3, rng)),
            ("two instances of the duplicated icosphere (ties), vertices and edges",
             dic.inst_tab, dcs, vertex_rays(dup_w, 32 * 12 + 17, rng)),
            ("two instances of the duplicated icosphere, axis-parallel and parked",
             dic.inst_tab, dcs, axis_parallel_np(np.array([0.0, 5.0, 0.0], np.float32),
                                                 32 * 12 + 1, rng))):
        err = max(err, hold_k7_rays(label, tab, cset, *np_rays(o, d, device),
                                    origin=torch.zeros(3, device=device)))
    # K5 with instances: config 5's cell and the duplicates as a scene
    dscene = dup_scene(device)
    dic_pt = make_instanced_clusters(pair, dcs, scene=dscene, device=device)
    hold_k5_rays("config 5, knot vertices and edges of the instances", c5["scene"], ic,
                 *np_rays(*vertex_rays(knot_w, 32 * 10 + 21, rng), device), seed, quat)
    hold_k5_rays("two instances of the duplicated icosphere (ties)", dscene, dic_pt,
                 *np_rays(*vertex_rays(dup_w, 32 * 8 + 3, rng), device), seed, quat)
    return err


def phase_c3_invariants(c3, quat, seed, device):
    """The config-3 path through K4, K5 and K6 against the plain versions
    and each other; -> the plain times, K5's error and the sweep work of
    the frame (for K5's bound), K4's frame numbers but its time."""
    from raytracing_engine_tpu_torch.ops.cuda import cluster, pt
    from raytracing_engine_tpu_torch.pathtracer.wavefront import render_pt_fast
    from raytracing_engine_tpu_torch.runtime import ProgressiveState, progressive_render

    _, cs, scene, cfg, _ = c3
    pos = torch.zeros(3, device=device)
    k5, n5 = pt.render_pt_rebin(cfg, scene, pos, quat, 1, seed=seed, bvh=cs)
    k4, n4 = pt.render_pt_mega(cfg, scene, pos, quat, 1, seed=seed, bvh=cs)
    same = torch.equal(k5, k4) and int(n5) == int(n4)
    log(f"  render_pt_rebin (none,morton) == render_pt_mega(bvh=cs) bit for bit: {same}; "
        f"rays {int(n5)} == {int(n4)}; lit pixels {(k4.amax(-1) > 0).double().mean().item():.4f}")
    if not same:
        raise AssertionError("K5 differs from K4 with clusters")
    for mode in ("none", "oct", "morton", "oct_morton", "tile_oct"):
        img, n = pt.render_pt_rebin(cfg, scene, pos, quat, 1, seed=seed, bvh=cs, rebin=mode)
        if not (torch.equal(img, k4) and int(n) == int(n4)):
            raise AssertionError(f"rebin={mode!r} differs from K4")
    log("  every regroup mode (none, oct, morton, oct_morton, tile_oct) == K4 bit for bit")

    cluster.work.update(slabs=0, tests=0)
    t0 = time.perf_counter()
    pr, prn = pt.render_pt_rebin_reference(cfg, scene, pos, quat, 1, seed=seed, bvh=cs)
    torch.cuda.synchronize(device)
    plain_rebin_ms = (time.perf_counter() - t0) * 1e3
    work = dict(cluster.work)
    err = hold_pt("K5 (render_pt_rebin) vs its plain version 512x512", k5, n5, pr, prn)
    log(f"  plain version 512x512: render_pt_rebin_reference {plain_rebin_ms:.1f} ms; sweep "
        f"work of the frame {work['slabs']} box + {work['tests']} triangle tests")

    # bands of both kernels bit for bit the rows of the full render
    row0, band_h = C3_BAND
    band = dict(seed=seed, bvh=cs, row0=row0, band_h=band_h)
    b5, _ = pt.render_pt_rebin(cfg, scene, pos, quat, 1, **band)
    b4, _ = pt.render_pt_mega(cfg, scene, pos, quat, 1, **band)
    rows = k4[row0:row0 + band_h]
    log(f"  band rows {row0}..{row0 + band_h}: K5 == full render rows {torch.equal(b5, rows)}, "
        f"K4 == full render rows {torch.equal(b4, rows)}")
    if not (torch.equal(b5, rows) and torch.equal(b4, rows)):
        raise AssertionError("a config-3 band differs from the rows of the full render")
    # K4 against its plain version on the whole frame, the band's rows
    # included; the replay counts the work of K4's least time
    k4_frame = hold_k4_frame("config 3", cfg, scene, cs, pos, quat, seed, k4, n4, device)

    f, nf = render_pt_fast(cfg, scene, pos, quat, 1, seed=seed, bvh=cs)
    hold_pt("render_pt_fast(bvh=cs) through K6 vs K4", f, nf, k4, n4)

    state = ProgressiveState.start(cfg, pos, quat, key=1, device=device)
    for state in progressive_render(cfg, scene, state, 4, passes_per_chunk=2, bvh=cs,
                                    render_fn=pt.render_pt_mega):
        pass
    one, _ = pt.render_pt_mega(cfg, scene, pos, quat, 4, seed=seed, bvh=cs)
    want = one * 4.0
    ok = torch.allclose(state.accum, want, rtol=C3_CHUNK_RTOL, atol=1e-6)
    log(f"  progressive_render(bvh=cs) 2 x 2 spp vs one 4-spp render (sums): max_abs_err="
        f"{(state.accum - want).abs().max().item():.6g} within rtol {C3_CHUNK_RTOL:.3g}: {ok}")
    if state.spp_done != 4 or not ok:
        raise AssertionError("progressive_render(bvh=cs) depends on the chunking")
    ragged = hold_k4_ragged("config 3", cfg, scene, cs, pos, quat, seed, C3_BAND[0], RAGGED_ROWS)
    k4_frame["max_abs_err"] = max(k4_frame["max_abs_err"], ragged)
    return {"max_abs_err": err, "plain_rebin_ms": plain_rebin_ms, "work": work,
            "nrays": int(n4), "k4": k4_frame}


def profile_rebin(cfg, scene, cs, quat, seed, zs, frame_ms, card):
    """torch.profiler over C3_FRAMES render_pt_rebin frames: device time of
    K5 per bounce, of the sort, the permute and the un-permute, and of the
    rest."""
    from torch.profiler import ProfilerActivity, profile

    from raytracing_engine_tpu_torch.ops.cuda import pt

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms, _ = cuda_ms(lambda k: pt.render_pt_rebin(cfg, scene, zs[k], quat, 1, seed=seed,
                                                          bvh=cs), C3_FRAMES)
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not events:
        log("  profiler: no device events; the split is not measured")
        return
    nb = cfg.max_bounces + 1
    k5 = [e.time_range.elapsed_us() for e in events if "pt_rebin_kernel" in e.name]
    per_bounce = [sum(k5[b::nb]) / C3_FRAMES for b in range(nb)]
    ops = {e.key: e for e in prof.key_averages()}

    def op_us(key):
        """Device time of the kernels that aten op `key` launched, per frame."""
        e = ops.get(key)
        if e is None:
            return 0.0
        return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) / C3_FRAMES

    split = {"sort": op_us("aten::sort"), "permute (index_select)": op_us("aten::index_select"),
             "un-permute (index_copy_)": op_us("aten::index_copy_")}
    busy = sum(e.time_range.elapsed_us() for e in events) / C3_FRAMES
    rest = busy - sum(per_bounce) - sum(split.values())
    log(f"  profile render_pt_rebin {cfg.width}x{cfg.height} ({C3_FRAMES} frames, profiler on: "
        f"{prof_ms:.4f} ms/frame): device busy {busy:.1f} us/frame = "
        f"{busy / 1e3 / frame_ms:.1%} of the unprofiled {frame_ms:.4f} ms frame; K5 by bounce "
        f"{[round(x, 1) for x in per_bounce]} us; "
        + ", ".join(f"{k} {v:.1f} us" for k, v in split.items())
        + f"; everything else (keys, bounding box, counters) {rest:.1f} us [{card}]")


def phase_c3_main(c3, quat, seed, device, card, inv):
    """Config 3's entry points under the launch counters, timed."""
    import dataclasses

    from raytracing_engine_tpu_torch.ops.cuda import cluster, pt
    from raytracing_engine_tpu_torch.pathtracer.wavefront import render_pt_fast
    from raytracing_engine_tpu_torch.runtime import ProgressiveState, progressive_render
    from raytracing_engine_tpu_torch.utils.timing import (
        bound_ms,
        cluster_table_bytes,
        k5_bytes,
        pt_ops,
        sweep_ops,
    )

    _, cs, scene, cfg, _ = c3
    hd = dataclasses.replace(cfg, **C3_HD)

    def frames(c, fn, n_frames, label):
        zs = [torch.tensor([0.0, 0.0, 1e-4 * k], device=device) for k in range(n_frames)]
        fn(c, scene, zs[0], quat, 1, seed=seed, bvh=cs)  # warm-up
        best = None
        for r in range(C3_ROUNDS):
            rays = []
            ms, host_ms = cuda_ms(lambda k: rays.append(
                fn(c, scene, zs[k], quat, 1, seed=seed, bvh=cs)[1]), n_frames)
            n = int(torch.stack(rays).sum()) // n_frames
            log(f"  {label} round {r}: {ms:.4f} ms/frame (host enqueue {host_ms:.4f} ms) "
                f"= {n / ms / 1e3:.2f} Mrays/s, {n} rays/frame [{card}]")
            if best is None or ms < best[0]:
                best = (ms, n)
        return best, zs

    reset_k4()
    pt.rebin_launches = cluster.launches = 0
    (c3_ms, c3_rays), zs = frames(cfg, pt.render_pt_rebin, C3_FRAMES,
                                  f"config 3 render_pt_rebin {cfg.width}x{cfg.height}")
    profile_rebin(cfg, scene, cs, quat, seed, zs, c3_ms, card)
    (hd_ms, hd_rays), _ = frames(hd, pt.render_pt_rebin, C3_HD_FRAMES,
                                 f"config 3 render_pt_rebin {hd.width}x{hd.height}")
    (mega_ms, _), _ = frames(cfg, pt.render_pt_mega, C3_FRAMES,
                             f"config 3 render_pt_mega(bvh=cs) {cfg.width}x{cfg.height}")
    pos = torch.zeros(3, device=device)
    fast_ms, _ = cuda_ms(lambda k: render_pt_fast(cfg, scene, pos, quat, 1, seed=seed, bvh=cs), 1)
    state = ProgressiveState.start(cfg, pos, quat, key=1, device=device)
    for state in progressive_render(cfg, scene, state, 2, passes_per_chunk=1, bvh=cs,
                                    render_fn=pt.render_pt_mega):
        pass
    torch.cuda.synchronize(device)
    counts = {"K4": pt.launches, "K5": pt.rebin_launches, "K6": cluster.launches}
    k4_clusters = pt.mesh_launches["clusters"]
    nb = cfg.max_bounces + 1
    rebin_frames = (1 + C3_ROUNDS * C3_FRAMES + C3_FRAMES) + (1 + C3_ROUNDS * C3_HD_FRAMES)
    want = {"K4": 1 + C3_ROUNDS * C3_FRAMES + 2, "K5": nb * rebin_frames, "K6": 2 * nb}
    log(f"  render_pt_fast(bvh=cs) {cfg.width}x{cfg.height}: {fast_ms:.2f} ms (K6 sweeps + the "
        f"plain wavefront around them) [{card}]")
    log(f"  launches on the config-3 main path {counts} (expected {want}: {nb} K5 per rebin frame "
        f"x {rebin_frames}, K4 per mega frame and progressive chunk, 2 K6 per bounce of the "
        f"render_pt_fast frame)")
    if counts != want or k4_clusters != counts["K4"]:
        raise AssertionError(f"config-3 launch counts {counts} (K4 with clusters {k4_clusters}) "
                             f"!= {want}")

    # K5 alone, bounce by bounce, on the states of the phase-11 frame: the
    # profiler's device time per launch
    k5_ms, k5_live = k5_bounce_ms(cfg, scene, cs, pos, quat, seed)
    fc = cluster.FrameClusters.at(cs, pos)
    tb = cluster.sweep_tables(cs)
    tables = cluster_table_bytes([tb.sbox, tb.crec, tb.trec, tb.tsmooth, fc.orders, fc.refs])
    tables += 4 * sum(t.numel() for t in pt.pack_pt_scene(pt.kernel_scene(scene, cs)))
    n = cfg.width * cfg.height
    ops = sweep_ops(inv["work"]["slabs"], inv["work"]["tests"]) + pt_ops(
        inv["nrays"], int(scene.sph_count), 0)
    k5_n_bytes = k5_bytes(n, k5_live, tables)
    k5_bound = bound_ms(k5_n_bytes, ops)
    k4 = inv["k4"]
    # K4 on the frame whose plain replay gave its bound (zs[0] == pos)
    k4_ms = device_ms(lambda _: pt.render_pt_mega(cfg, scene, pos, quat, 1, seed=seed, bvh=cs),
                      K4_REPS, "pt_kernel")
    log(f"  K5 alone per bounce (device time) {[round(x, 4) for x in k5_ms]} ms = "
        f"{sum(k5_ms):.4f} ms/frame; "
        f"bound {k5_bound[0]:.5f} ms by {k5_bound[1]} ({ops} ops: sweeps + "
        f"{int(scene.sph_count)} spheres x {inv['nrays']} rays; {k5_n_bytes} B: {n} rays' "
        f"state written, then {k5_live} live rays read and written); K5 at "
        f"{k5_bound[0] / sum(k5_ms):.2%} of it [{card}]")
    log(f"  config 3 512x512: rebin {c3_ms:.4f} ms/frame = {c3_rays / c3_ms / 1e3:.2f} Mrays/s; "
        f"mega {mega_ms:.4f} ms/frame; 1920x1088 rebin {hd_ms:.4f} ms/frame = "
        f"{hd_rays / hd_ms / 1e3:.2f} Mrays/s; K4 config-3 frame bound {k4['bound_ms']:.5f} ms "
        f"by {k4['bound_by']}; K4 {k4_ms:.4f} ms of device time a frame (the profiler's), at "
        f"{k4['bound_ms'] / k4_ms:.2%} of it [{card}]")
    return {"launches": counts, "k5": {"ms": sum(k5_ms), "plain_ms": inv["plain_rebin_ms"],
                                       "bound_ms": k5_bound[0], "bound_by": k5_bound[1]},
            "k4": {**k4, "ms": k4_ms}}


def device_ms(launch, reps: int, name: str, setup=lambda k: None) -> float:
    """Median device time (ms) of kernel `name` over reps calls of
    launch(setup(k)), setup's work (a fresh input) made before each call:
    by torch.profiler, after one call outside it. Where three profiled runs
    record no device event (it happens now and then), each call is timed by
    CUDA events instead, enqueued behind a spin kernel so that the events
    bracket the kernel and not the host's enqueue. Raises unless the time is
    finite and positive."""
    from torch.profiler import ProfilerActivity, profile

    launch(setup(reps))
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for k in range(reps):
                launch(setup(k))
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
        if us:
            ms = sorted(us)[len(us) // 2] / 1e3
            break
    else:
        times = []
        for k in range(reps):
            x = setup(k)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            launch(x)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = sorted(times)[len(times) // 2]
        log(f"  {name}: the profiler recorded no device event in 3 runs; CUDA events behind a "
            f"spin kernel: {ms:.4f} ms")
    if not (math.isfinite(ms) and ms > 0.0):
        raise AssertionError(f"{name}: no device time measured ({ms})")
    return ms


def k5_states(run, cfg, gpass: int = 0) -> list:
    """The state each K5 launch of pass gpass reads, as render_pt_rebin hands
    them on (its default regroup between bounces): None for bounce 0, which
    makes a new one, then copies (K5 updates the state in place). run: a
    rebin_bounce_launcher's."""
    from raytracing_engine_tpu_torch.ops.cuda import pt

    modes = pt._gap_modes("none,morton")
    inputs = [None]
    st, _ = run(0, None, gpass)
    for b in range(1, cfg.max_bounces + 1):
        st = pt.regroup(st, modes[min(b - 1, len(modes) - 1)])
        inputs.append(st.clone())
        st, _ = run(b, st, gpass)
    return inputs


def k5_events_ms(run, states) -> float:
    """Device ms of a frame's K5 launches, each timed by CUDA events behind a
    spin kernel on a fresh copy of the state it reads, summed. states: for
    each pass g, k5_states(run, cfg, g). The events also hold the launch's
    one-element ray-count fill."""
    total = 0.0
    for g, inputs in enumerate(states):
        for b, x in enumerate(inputs):
            y = None if x is None else x.clone()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            run(b, y, g)
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
    return total


def live_rays(states) -> list:
    """The rays K5 finds not parked (|o.x| < 1e17) in each state after
    bounce 0's (utils/timing.k5_bytes's live)."""
    from raytracing_engine_tpu_torch.ops.cuda import cluster

    return [int((x[0].abs() < cluster.PARKED).sum()) for x in states[1:]]


def k5_bounce_ms(cfg, scene, bvh, pos, quat, seed) -> tuple[list, list]:
    """K5's device time per bounce on the states of one frame (render_pt_rebin's
    default regroup between bounces), each timed launch on a fresh copy of
    its bounce's state; and the live rays of those states."""
    from raytracing_engine_tpu_torch.ops.cuda import pt

    _, _, run = pt.rebin_bounce_launcher(cfg, scene, pos, quat, seed, bvh)
    inputs = k5_states(run, cfg)
    ms = [device_ms(lambda y, b=b: run(b, y, 0), 9, "pt_rebin_kernel",
                    setup=lambda k, x=x: None if x is None else x.clone())
          for b, x in enumerate(inputs)]
    return ms, live_rays(inputs)


def phase_bvh_kernel(c3, quat, seed, device, card):
    """K8 against its plain version on config 3's mesh as a raw BVH and on
    the rays where a walk can break (ties, cut walks, ragged counts), bit
    for bit; K8 timed on the camera, bounce-1 and shadow rays, beside K6 on
    the camera rays; -> (K8's results, the BVH)."""
    from raytracing_engine_tpu_torch.accel import build_bvh, icosphere
    from raytracing_engine_tpu_torch.ops.cuda import bvh_traverse as kbvh
    from raytracing_engine_tpu_torch.ops.cuda import cluster
    from raytracing_engine_tpu_torch.pathtracer.wavefront import BVH_MAX_STEPS
    from raytracing_engine_tpu_torch.utils.timing import bound_ms, bvh_ops, k8_bytes

    mesh, cs, _, cfg, _ = c3
    t0 = time.perf_counter()
    bvh = build_bvh(mesh, device=device)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    tables = kbvh.tables_of(bvh)
    n_nodes, n_tris = bvh.bb_min.shape[0], bvh.v0.shape[0]
    log(f"  config-3 raw BVH: {n_nodes} nodes over {n_tris} triangles, builder {bvh.builder}, "
        f"host build {build_s:.3f} s")
    o0, d0, o1, d1, wi, dist = c3_rays(c3, quat, seed, device)
    small = kbvh.tables_of(build_bvh(icosphere(subdivisions=2, radius=1.2,
                                               center=(0.0, 5.0, 0.0)), device=device))
    dup = kbvh.tables_of(build_bvh(dup_icosphere(), device=device))
    oa, da = axis_parallel_rays(device)
    rng = np.random.default_rng(11)
    ov, dv = np_rays(*vertex_rays(dup_icosphere(), 32 * 12 + 5, rng), device)
    # ragged counts through the middle of the image, where the knot is
    mid = cfg.height // 2
    o_rag, d_rag = (tuple(p[mid - 6:mid + 7, 1:510] for p in x) for x in (o0, d0))
    o_row, d_row = (tuple(p[mid, :].reshape(-1)[5:] for p in x) for x in (o0, d0))
    inf = float("inf")
    steps = dict(max_steps=BVH_MAX_STEPS)  # the wavefront's cap
    size = f"{cfg.width}x{cfg.height}"
    cases = [
        (f"camera rays {size}, closest", tables, o0, d0, inf, {}),
        ("bounce-1 rays, closest", tables, o1, d1, inf, {}),
        ("bounce-1 NEE shadow rays, any hit", tables, o1, wi, dist * 0.999, dict(any_hit=True)),
        ("axis-parallel + parked rays vs icosphere(2), closest", small, oa, da, inf, {}),
        ("axis-parallel + parked rays vs icosphere(2), any hit t_max=2", small, oa, da, 2.0,
         dict(any_hit=True)),
        ("duplicated icosphere (every hit a tie), vertices and edges, closest", dup, ov, dv,
         inf, {}),
        ("duplicated icosphere, vertices and edges, any hit", dup, ov, dv, inf,
         dict(any_hit=True)),
        (f"duplicated icosphere, walks cut at max_steps={K8_CUT_STEPS[0]}", dup, ov, dv, inf,
         dict(max_steps=K8_CUT_STEPS[0])),
        (f"camera rays {size}, walks cut at max_steps={K8_CUT_STEPS[1]}", tables, o0, d0, inf,
         dict(max_steps=K8_CUT_STEPS[1])),
        (f"camera rays, a 13 x 509 band of the middle rows ({13 * 509} rays: ragged blocks "
         "and warps)", tables, o_rag, d_rag, inf, {}),
        (f"camera rays, {cfg.width - 5} of the middle row in a flat list (a ragged last warp)",
         tables, o_row, d_row, inf, {}),
    ]
    err, plain = 0.0, {}
    for k, (label, tb, o, d, t_max, kw) in enumerate(cases):
        kw = {**steps, **kw}
        got = kbvh.bvh_intersect_packet(tb, o, d, t_max, **kw)
        torch.cuda.synchronize(device)
        kbvh.work.update(nodes=0, tests=0)
        t0 = time.perf_counter()
        want = kbvh.bvh_intersect_packet_reference(tb, o, d, t_max, **kw)
        torch.cuda.synchronize(device)
        if k < 3:
            plain[k] = dict(plain_ms=(time.perf_counter() - t0) * 1e3, **kbvh.work)
        err = max(err, hold_sweep(f"K8 {label}", got, want, "K8"))

    # K8 alone on the camera, bounce-1 and shadow rays (the profiler's device
    # time: a K8 launch takes about as long as its wrapper's host work), and
    # K6 on the camera rays and the same mesh
    fc = cluster.FrameClusters.at(cs, torch.zeros(3, device=device))
    k6kw = dict(order=fc.orders[0], orders=fc.orders, refs=fc.refs)
    n = cfg.width * cfg.height
    rows = []
    for k, label in enumerate(("camera rays", "bounce-1 rays", "shadow rays")):
        _, tb, o, d, t_max, kw = cases[k]
        ms = device_ms(lambda _, o=o, d=d, t_max=t_max, kw=kw: kbvh.bvh_intersect_packet(
            tb, o, d, t_max, **kw, **steps), K8_REPS, "traverse_kernel")
        n_bytes = k8_bytes(n, n_nodes, n_tris, tmax_plane=k == 2)
        n_ops = bvh_ops(plain[k]["nodes"], plain[k]["tests"])
        bound = bound_ms(n_bytes, n_ops)
        rows.append(dict(ms=ms, plain_ms=plain[k]["plain_ms"], bound_ms=bound[0],
                         bound_by=bound[1]))
        log(f"  K8 {label} {size}: {ms:.4f} ms (device time by the profiler, median of "
            f"{K8_REPS}); plain {plain[k]['plain_ms']:.1f} ms; {plain[k]['nodes']} node + "
            f"{plain[k]['tests']} triangle tests -> bound {bound[0]:.5f} ms by {bound[1]} "
            f"({n_bytes} B, {n_ops} ops), kernel at {bound[0] / ms:.2%} of it [{card}]")
    k6_ms = device_ms(lambda _: cluster.cluster_intersect(cs, o0, d0, inf, **k6kw), K8_REPS,
                      "cluster_kernel")
    log(f"  K8 summed over the three ray sets {sum(r['ms'] for r in rows):.4f} ms; K6 on the "
        f"camera rays and the same mesh {k6_ms:.4f} ms (K8 at {k6_ms / rows[0]['ms']:.2f}x its "
        f"speed) [{card}]")
    return {"max_abs_err": err, **rows[0]}, bvh


def c5_setup(device):
    """Config 5 as benchmarks/run_all.py:338-345 and :456-471 build it: the
    knot, its BVH and ClusterSet (no triangle materials), the 30 instances,
    the Phong cells' albedos and light, and the path-traced cell's scene and
    InstancedClusters."""
    from raytracing_engine_tpu_torch.accel import (
        build_bvh,
        build_clusters,
        grid_instances,
        make_instanced_clusters,
        torus_knot,
    )
    from raytracing_engine_tpu_torch.pathtracer import DIFFUSE, PTConfig, build_pt_scene

    mesh = torus_knot(**C5_KNOT)
    t0 = time.perf_counter()
    bvh = build_bvh(mesh, device=device)
    cs = build_clusters(mesh, device=device)
    inst = grid_instances(bvh, **C5_GRID, mats=np.arange(30, dtype=np.int32) % 3,
                          device=device)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    scene = build_pt_scene(
        spheres=[((8.0, 2.0, 10.0), 2.0, 3), ((0.0, 14.0, -103.0), 100.0, 4)],
        materials=[{"albedo": (0.75, 0.5, 0.3), "kind": DIFFUSE},
                   {"albedo": (0.4, 0.7, 0.5), "kind": DIFFUSE},
                   {"albedo": (0.5, 0.5, 0.8), "kind": DIFFUSE},
                   {"albedo": (0, 0, 0), "emission": (40.0, 38.0, 34.0), "kind": DIFFUSE},
                   {"albedo": (0.55, 0.55, 0.5), "kind": DIFFUSE}], device=device)
    ic = make_instanced_clusters(inst, cs, scene=scene, device=device)
    return dict(mesh=mesh, bvh=bvh, cs=cs, inst=inst, ic=ic, scene=scene, build_s=build_s,
                albedo=torch.tensor(C5_ALBEDO, device=device),
                light=torch.tensor(C5_LIGHT, device=device), cam=torch.zeros(3, device=device),
                cfg=PTConfig(**C5_PT, rng="pcg"))


def instances_hit(code, t_pad: int, n_inst: int) -> int:
    """How many distinct instances the hit codes of a plane name."""
    inst = code[code >= 0] // t_pad
    return int(torch.bincount(inst.long(), minlength=n_inst).gt(0).sum())


def busiest_rows(code, t_pad: int, n_inst: int, bh: int) -> tuple[int, int]:
    """(row0, instances): the first run of bh rows whose hit codes name the
    most distinct instances, and how many they name."""
    h = code.shape[0]
    inst = torch.where(code >= 0, code // t_pad + 1, 0).long()
    rows = torch.zeros(h, n_inst + 1, device=code.device).scatter_(1, inst, 1.0)[:, 1:]
    cover = rows.unfold(0, bh, 1).amax(-1).gt(0).sum(1)
    row0 = int(torch.argmax(cover))
    return row0, int(cover[row0])


def phase_instanced_kernel(c5, quat, seed, device):
    """K7 and the instanced paths against their plain versions on the card;
    -> (K7's max error, K4<instances>'s frame numbers but its time)."""
    from raytracing_engine_tpu_torch.accel import (
        build_bvh,
        build_clusters,
        grid_instances,
        icosphere,
        make_instanced_clusters,
        make_instances,
    )
    from raytracing_engine_tpu_torch.models.instanced import (
        camera_rays,
        render_instanced_phong,
        render_instanced_phong_reference,
        shadow_rays,
    )
    from raytracing_engine_tpu_torch.ops.cuda import instanced as kinst
    from raytracing_engine_tpu_torch.ops.cuda import pt
    from raytracing_engine_tpu_torch.ops.rng_pcg import pass_seed, uniform_pcg
    from raytracing_engine_tpu_torch.pathtracer.wavefront import _camera_rays, render_pt_fast

    cs, ic, cam, cfg, scene = c5["cs"], c5["ic"], c5["cam"], c5["cfg"], c5["scene"]
    log(f"  config 5: {ic.num_instances} instances x {c5['mesh'].shape[0]} triangles = "
        f"{c5['inst'].total_triangles} triangles; base set {cs.num_clusters} clusters, "
        f"{cs.num_super} super clusters, {cs.padded_tris} slots; host build {c5['build_s']:.3f} s")

    def held(label, tab, cset, o, d, **kw):
        got = kinst.instanced_cluster_intersect(tab, cset, o, d, **kw)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        want = kinst.instanced_cluster_intersect_reference(tab, cset, o, d, **kw)
        torch.cuda.synchronize(device)
        err = hold_sweep(f"K7 {label} (plain {time.perf_counter() - t0:.1f} s)", got, want, "K7")
        return err, got

    # reduced: 2 x 2 instances of the knot at the path tracer's 512x512
    inst4 = grid_instances(c5["bvh"], nx=2, ny=2, spacing=4.0, base=(0.0, 14.0, 0.0),
                           mats=[0, 1, 2, 0], device=device)
    ic4 = make_instanced_clusters(inst4, cs, device=device)
    u = uniform_pcg(pass_seed(seed, 0), 0, 2, cfg.height, cfg.width, device=device)
    o0, d0 = _camera_rays(cfg, cam, quat, u[0], u[1])
    o0, d0 = tuple(x.contiguous() for x in o0), tuple(x.contiguous() for x in d0)
    errs = []
    e, got = held(f"2x2 instances, camera rays {cfg.width}x{cfg.height}, closest + normal",
                  ic4.inst_tab, cs, o0, d0, attrs=True, origin=cam)
    errs.append(e)
    so, sd, tm = shadow_rays(o0, d0, got, c5["light"])
    errs.append(held("2x2 instances, render_instanced_phong's shadow rays from those hits "
                     "(misses and back faces parked), any hit", ic4.inst_tab, cs, so, sd,
                     any_hit=True, t_max=tm, origin=cam)[0])
    ico = icosphere(subdivisions=2, radius=1.0)
    rot = np.array([[np.cos(0.7), -np.sin(0.7), 0.0], [np.sin(0.7), np.cos(0.7), 0.0],
                    [0.0, 0.0, 1.0]], np.float32)
    pair = make_instances(build_bvh(ico, device=device),
                          [(np.eye(3, dtype=np.float32), (0.0, 5.0, 0.0), 1.2),
                           (rot, (0.6, 5.4, 0.3), 0.8)], device=device)
    icp = make_instanced_clusters(pair, build_clusters(ico, device=device), device=device)
    oa, da = axis_parallel_rays(device)
    errs.append(held("axis-parallel + parked rays vs 2 scaled instances, closest + normal",
                     icp.inst_tab, icp.cs, oa, da, attrs=True)[0])
    errs.append(held("axis-parallel + parked rays vs 2 scaled instances, any hit t_max=2",
                     icp.inst_tab, icp.cs, oa, da, any_hit=True, t_max=2.0)[0])

    # the full config 5: render_instanced_phong through K7 against its plain
    # version on a band (its K7 closest and any-hit launches on the path's own
    # rays; the whole frame's camera rays are held in phase 15, where their
    # replay gives K7's bound), and bands
    n_inst, t_pad = ic.num_instances, cs.padded_tris
    width, height = C5_SIZE
    row0, bh = C5_BAND
    ob, db = camera_rays(cam, 0.0, width, height, row0=row0, band_h=bh)
    band_code = kinst.instanced_cluster_intersect(ic.inst_tab, cs, ob, db, origin=cam)[1]
    log(f"  Phong rows {row0}..{row0 + bh}: the camera rays hit "
        f"{instances_hit(band_code, t_pad, n_inst)} of the {n_inst} instances")
    args = (ic.inst_tab, cs, c5["inst"].mat, c5["albedo"], cam, 0.0, c5["light"])
    band = dict(row0=row0, band_h=bh)
    for label, kw in (("hard shadows", {}), (f"soft shadows {C5_SOFT}", C5_SOFT)):
        full = render_instanced_phong(*args, **kw)
        got = render_instanced_phong(*args, **kw, **band)
        t0 = time.perf_counter()
        want = render_instanced_phong_reference(*args, **kw, **band)
        torch.cuda.synchronize(device)
        plain_s = time.perf_counter() - t0
        same, rows = torch.equal(got, want), torch.equal(got, full[row0:row0 + bh])
        log(f"  render_instanced_phong {width}x{height}, {label}: rows {row0}..{row0 + bh} "
            f"through K7 == plain version bit for bit: {same} (plain {plain_s:.1f} s); band == "
            f"rows of the full frame: {rows}; lit pixels "
            f"{(full.amax(-1) > 0).double().mean().item():.4f}, finite "
            f"{bool(torch.isfinite(full).all())}")
        if not (same and rows and torch.isfinite(full).all()):
            raise AssertionError(f"render_instanced_phong ({label}) differs from its plain "
                                 "version or from the full frame")

    # the path-traced cell: K5 == K4, both against their plain versions
    k4, n4 = pt.render_pt_mega(cfg, scene, cam, quat, 1, seed=seed, bvh=ic)
    for mode in ("none,morton", "none", "oct", "morton", "oct_morton", "tile_oct"):
        img, n = pt.render_pt_rebin(cfg, scene, cam, quat, 1, seed=seed, bvh=ic, rebin=mode)
        if not (torch.equal(img, k4) and int(n) == int(n4)):
            raise AssertionError(f"config 5: rebin={mode!r} differs from K4")
    log(f"  config 5 PT {cfg.width}x{cfg.height}: render_pt_rebin == render_pt_mega(bvh=ic) bit "
        f"for bit in every regroup mode (none,morton, none, oct, morton, oct_morton, tile_oct); "
        f"rays {int(n4)}; lit pixels {(k4.amax(-1) > 0).double().mean().item():.4f}")
    # K4 and K5 on the band of rows whose camera rays hit the most instances,
    # bit for bit the rows of the full render; K5 against its plain version
    # there, K4 against its own on every C5_PT_PLAIN_STRIDE-th row (its
    # replay counts the work of K4's least time)
    cam_code = kinst.instanced_cluster_intersect(ic.inst_tab, cs, o0, d0, origin=cam)[1]
    row0, covered = busiest_rows(cam_code, t_pad, n_inst, C5_PT_BAND_H)
    bh = C5_PT_BAND_H
    rows = f"rows {row0}..{row0 + bh} (their camera rays hit {covered} of the {n_inst} instances)"
    kw = dict(seed=seed, bvh=ic, row0=row0, band_h=bh)
    b4, _ = pt.render_pt_mega(cfg, scene, cam, quat, 1, **kw)
    band, nband = pt.render_pt_rebin(cfg, scene, cam, quat, 1, **kw)
    if not (torch.equal(b4, k4[row0:row0 + bh]) and torch.equal(band, k4[row0:row0 + bh])):
        raise AssertionError("a config-5 K4 or K5 band differs from the rows of the full render")
    t0 = time.perf_counter()
    want, nwant = pt.render_pt_rebin_reference(cfg, scene, cam, quat, 1, **kw)
    torch.cuda.synchronize(device)
    hold_pt(f"K5 with {n_inst} instances vs its plain version, {rows} (plain "
            f"{time.perf_counter() - t0:.1f} s; K4's and K5's bands == full-frame rows)", band,
            nband, want, nwant)
    k4_frame = hold_k4_frame("config 5 PT", cfg, scene, ic, cam, quat, seed, k4, n4, device,
                             stride=C5_PT_PLAIN_STRIDE)
    f, nf = render_pt_fast(cfg, scene, cam, quat, 1, seed=seed, bvh=ic)
    hold_pt("render_pt_fast(bvh=ic) through K7 vs K4", f, nf, k4, n4)
    # K4 with instances on the ragged band, through the two scaled icosphere
    # instances (config 5's lights and materials): the plain two-level sweep
    # costs seconds per call, instance and super cluster (61.6 s for 3 rows
    # of the 30 knots at 3 spp, 27.7 s for 5 rows of 2 x 2 knots)
    code = kinst.instanced_cluster_intersect(icp.inst_tab, icp.cs, o0, d0, origin=cam)[1]
    row0, _ = busiest_rows(code, icp.cs.padded_tris, icp.num_instances, RAGGED_ROWS)
    ragged = hold_k4_ragged("2 icosphere instances", cfg, scene, icp, cam, quat, seed, row0,
                            RAGGED_ROWS)
    k4_frame["max_abs_err"] = max(k4_frame["max_abs_err"], ragged)
    return max(errs), k4_frame


def phase_c5_main(c5, c3, bvh3, quat, seed, device, card, k4):
    """The slice's main paths under the launch counters, timed; the
    profiler splits; K7 alone on a Phong frame, held to its plain version
    bit for bit, and its least time; -> the launches and K7's numbers."""
    from torch.profiler import ProfilerActivity, profile

    from raytracing_engine_tpu_torch.models.instanced import camera_rays, render_instanced_phong
    from raytracing_engine_tpu_torch.ops.cuda import bvh_traverse as kbvh
    from raytracing_engine_tpu_torch.ops.cuda import cluster, pt
    from raytracing_engine_tpu_torch.ops.cuda import instanced as kinst
    from raytracing_engine_tpu_torch.pathtracer.wavefront import render_pt_fast
    from raytracing_engine_tpu_torch.utils.timing import (
        bound_ms,
        cluster_table_bytes,
        instanced_ops,
        k7_bytes,
    )

    cs, ic, cam, cfg, scene = c5["cs"], c5["ic"], c5["cam"], c5["cfg"], c5["scene"]
    width, height = C5_SIZE
    phong = (ic.inst_tab, cs, c5["inst"].mat, c5["albedo"], cam)
    yaws = [torch.tensor(y, dtype=torch.float32, device=device)
            for y in np.linspace(0.0, 0.5, C5_FRAMES)]
    zs = [torch.tensor([0.0, 0.0, 1e-4 * k], device=device) for k in range(C5_PT_FRAMES)]

    def rounds(label, fn, n_frames):
        """Best ms/frame of C5_ROUNDS rounds of n_frames chained frames (a
        warm-up first); fn(k) -> its ray count or None."""
        fn(0)
        best = None
        for r in range(C5_ROUNDS):
            rays = []
            ms, host_ms = cuda_ms(lambda k: rays.append(fn(k)), n_frames)
            n = None if rays[0] is None else int(torch.stack(rays).sum()) // n_frames
            rate = "" if n is None else f" = {n / ms / 1e3:.2f} Mrays/s, {n} rays/frame"
            log(f"  {label} round {r}: {ms:.4f} ms/frame (host enqueue {host_ms:.4f} ms){rate} "
                f"[{card}]")
            if best is None or ms < best[0]:
                best = (ms, n)
        return best

    def phong_frame(k, **kw):
        render_instanced_phong(*phong, yaws[k], c5["light"], **kw)

    reset_k4()
    kinst.launches = kbvh.launches = cluster.launches = pt.rebin_launches = 0
    hard_ms, _ = rounds(f"config 5 Phong orbit {width}x{height}, hard shadows", phong_frame,
                        C5_FRAMES)
    soft_ms, _ = rounds(f"config 5 soft-shadow orbit {width}x{height} {C5_SOFT}",
                        lambda k: phong_frame(k, **C5_SOFT), C5_SOFT_FRAMES)
    rebin_ms, rays5 = rounds(f"config 5 PT render_pt_rebin(bvh=ic) {cfg.width}x{cfg.height}",
                             lambda k: pt.render_pt_rebin(cfg, scene, zs[k], quat, 1, seed=seed,
                                                          bvh=ic)[1], C5_PT_FRAMES)
    mega_ms, _ = rounds(f"config 5 PT render_pt_mega(bvh=ic) {cfg.width}x{cfg.height}",
                        lambda k: pt.render_pt_mega(cfg, scene, zs[k], quat, 1, seed=seed,
                                                    bvh=ic)[1], C5_PT_FRAMES)
    _, _, scene3, cfg3, _ = c3
    raw_ms, rays3 = rounds(f"config 3 render_pt_fast(bvh=raw BVH) {cfg3.width}x{cfg3.height}",
                           lambda k: render_pt_fast(cfg3, scene3, zs[k], quat, 1, seed=seed,
                                                    bvh=bvh3)[1], RAW_FRAMES)
    torch.cuda.synchronize(device)
    counts = {"K7": kinst.launches, "K8": kbvh.launches, "K4": pt.launches,
              "K5": pt.rebin_launches, "K6": cluster.launches}
    k4_instances = pt.mesh_launches["instances"]
    nb = cfg.max_bounces + 1

    def runs(n_frames):  # the warm-up and the timed rounds
        return 1 + C5_ROUNDS * n_frames

    want = {"K7": 2 * runs(C5_FRAMES) + (1 + C5_SOFT["shadow_samples"]) * runs(C5_SOFT_FRAMES),
            "K8": 2 * nb * runs(RAW_FRAMES), "K4": runs(C5_PT_FRAMES),
            "K5": nb * runs(C5_PT_FRAMES), "K6": 0}
    log(f"  launches on the slice's main paths {counts} (expected {want}: 2 K7 per hard-shadow "
        f"frame, {1 + C5_SOFT['shadow_samples']} per soft-shadow frame, {nb} K5 per rebin frame, "
        f"1 K4 per mega frame, {2 * nb} K8 per render_pt_fast frame: closest and shadow per "
        f"bounce)")
    if counts != want or k4_instances != counts["K4"]:
        raise AssertionError(f"config-5 / raw-BVH launch counts {counts} (K4 with instances "
                             f"{k4_instances}) != {want}")
    # K4 on the frame whose plain replay (phase 14) gave its bound
    k4_ms = device_ms(lambda _: pt.render_pt_mega(cfg, scene, c5["cam"], quat, 1, seed=seed,
                                                  bvh=ic), K4_REPS, "pt_kernel")
    log(f"  K4 config 5 PT {cfg.width}x{cfg.height}: {k4_ms:.4f} ms of device time a frame (the "
        f"profiler's), at {k4['bound_ms'] / k4_ms:.2%} of its bound {k4['bound_ms']:.5f} ms by "
        f"{k4['bound_by']} [{card}]")

    # profiler: K7 closest against any hit per Phong frame; K5 per bounce
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms, _ = cuda_ms(phong_frame, C5_FRAMES)
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if events:
        k7 = [e.time_range.elapsed_us() for e in events if "instanced_kernel" in e.name]
        busy = sum(e.time_range.elapsed_us() for e in events) / C5_FRAMES
        closest, anyhit = sum(k7[0::2]) / C5_FRAMES, sum(k7[1::2]) / C5_FRAMES
        log(f"  profile Phong orbit ({C5_FRAMES} frames, profiler on: {prof_ms:.4f} ms/frame): "
            f"K7 closest {closest:.1f} us + any hit {anyhit:.1f} us per frame; device busy "
            f"{busy:.1f} us/frame = {busy / 1e3 / hard_ms:.1%} of the unprofiled {hard_ms:.4f} "
            f"ms frame; the rest (Phong math, orders) {busy - closest - anyhit:.1f} us [{card}]")
    else:
        log("  profiler: no device events; the Phong split is not measured")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms, _ = cuda_ms(lambda k: pt.render_pt_rebin(cfg, scene, zs[k], quat, 1, seed=seed,
                                                          bvh=ic), C5_PT_FRAMES)
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if events:
        k5 = [e.time_range.elapsed_us() for e in events if "pt_rebin_kernel" in e.name]
        per_bounce = [sum(k5[b::nb]) / C5_PT_FRAMES for b in range(nb)]
        busy = sum(e.time_range.elapsed_us() for e in events) / C5_PT_FRAMES
        log(f"  profile config 5 PT render_pt_rebin ({C5_PT_FRAMES} frames, profiler on: "
            f"{prof_ms:.4f} ms/frame): K5 by bounce {[round(x, 1) for x in per_bounce]} us; device "
            f"busy {busy:.1f} us/frame = {busy / 1e3 / rebin_ms:.1%} of the unprofiled "
            f"{rebin_ms:.4f} ms frame; the regroup and the rest {busy - sum(per_bounce):.1f} us "
            f"[{card}]")
    else:
        log("  profiler: no device events; the K5 split is not measured")

    # K7 alone on the camera rays of a Phong frame (closest + normal), and
    # its least time from the plain version's replay of the same rays
    o, d = camera_rays(cam, 0.0, width, height)
    o, d = tuple(x.contiguous() for x in o), tuple(x.contiguous() for x in d)
    # the frame's orders made once, as render_instanced_phong makes them, so
    # the timed loop enqueues the kernel alone: building them per call makes
    # the loop host-bound
    iorder, iorders = kinst.instance_orders(ic.inst_tab, cs, cam)
    kw = dict(attrs=True, iorder=iorder, iorders=iorders)
    got = kinst.instanced_cluster_intersect(ic.inst_tab, cs, o, d, **kw)  # and warm-up
    k7_call = lambda k: kinst.instanced_cluster_intersect(ic.inst_tab, cs, o, d, **kw)  # noqa: E731
    ev_ms, host_ms = cuda_ms(k7_call, K7_REPS)
    ms = device_ms(lambda _: k7_call(0), K7_REPS, "instanced_kernel")
    kinst.work.update(gates=0, transforms=0)
    cluster.work.update(slabs=0, tests=0)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    want = kinst.instanced_cluster_intersect_reference(ic.inst_tab, cs, o, d, **kw)
    torch.cuda.synchronize(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = hold_sweep(f"K7 config 5, Phong camera rays {width}x{height} (yaw 0), closest + normal",
                     got, want, "K7")
    tb = cluster.sweep_tables(cs)
    n = width * height
    tables = cluster_table_bytes([tb.sbox, tb.crec, tb.trec, tb.tsmooth, ic.inst_tab, iorders])
    n_bytes = k7_bytes(n, True, tables)  # a scalar t_max: no plane read
    n_ops = instanced_ops(kinst.work["gates"], kinst.work["transforms"], cluster.work["slabs"],
                          cluster.work["tests"])
    bound = bound_ms(n_bytes, n_ops)
    log(f"  K7 Phong camera rays {width}x{height} (closest + normal): kernel {ms:.4f} ms of "
        f"device time (CUDA events {ev_ms:.4f} ms, host enqueue {host_ms:.4f} ms), plain {plain_ms:.1f} ms; {kinst.work['gates']} instance "
        f"gates, {kinst.work['transforms']} transforms, {cluster.work['slabs']} box + "
        f"{cluster.work['tests']} triangle tests -> bound {bound[0]:.5f} ms by {bound[1]} "
        f"({n_bytes} B, {n_ops} ops), kernel at {bound[0] / ms:.2%} of it [{card}]")
    log(f"  config 5: Phong orbit {hard_ms:.4f} ms/frame = {1e3 / hard_ms:.1f} fps, soft shadows "
        f"{soft_ms:.4f} ms/frame; PT 512x512 rebin {rebin_ms:.4f} ms/frame = "
        f"{rays5 / rebin_ms / 1e3:.2f} Mrays/s, mega {mega_ms:.4f} ms/frame; config 3 raw BVH "
        f"render_pt_fast {raw_ms:.4f} ms/frame = {rays3 / raw_ms / 1e3:.2f} Mrays/s [{card}]")
    return {"launches": counts, "k7_err": err, "k4": {**k4, "ms": k4_ms},
            "k7": {"ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound[0], "bound_by": bound[1]}}


def time_k9(key, device, card):
    """K9 at K9_SHAPE by CUDA events over back-to-back calls and by
    torch.profiler, its plain version, and torch.rand at the same shape
    (Philox, another stream: for scale only)."""
    from torch.profiler import ProfilerActivity, profile

    from raytracing_engine_tpu_torch.ops import rng
    from raytracing_engine_tpu_torch.ops.cuda import rng as krng

    n, h, w = K9_SHAPE
    krng.uniform_key(key, n, h, w, device=device)  # warm-up
    ms, host_ms = cuda_ms(lambda k: krng.uniform_key(key, n, h, w, device=device), K9_REPS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cuda_ms(lambda k: krng.uniform_key(key, n, h, w, device=device), K9_REPS)
    k9 = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and "rng_kernel" in e.name]
    device_ms = sum(k9) / len(k9) / 1e3 if k9 else None
    rng.uniform(key, n, h, w, device=device)
    plain_ms, _ = cuda_ms(lambda k: rng.uniform(key, n, h, w, device=device), 3)
    torch.rand(K9_SHAPE, device=device)
    rand_ms, _ = cuda_ms(lambda k: torch.rand(K9_SHAPE, device=device), K9_REPS)
    log(f"  K9 {K9_SHAPE}: {ms:.4f} ms by CUDA events (host enqueue {host_ms:.4f} ms), "
        + (f"{device_ms:.4f} ms device time by the profiler ({len(k9)} launches)"
           if k9 else "profiler: no device events, device time not measured")
        + f"; plain version {plain_ms:.2f} ms; torch.rand (Philox, another stream, for "
        f"scale only) {rand_ms:.4f} ms [{card}]")
    return ms, device_ms, plain_ms


def draws_match_plain(cfg2, scene, pos, quat, device):
    """Every K9 draw of one config-2 pass of the main path (global pass 0 of
    key=1), at threefry and at pallas: the key it was drawn under against
    the one the JAX package derives, and the kernel's planes against the
    plain version's on the same key and shape, bit for bit."""
    import dataclasses

    from raytracing_engine_tpu_torch.ops import rng
    from raytracing_engine_tpu_torch.ops.cuda import rng as krng
    from raytracing_engine_tpu_torch.ops.rng_pcg import to_int32
    from raytracing_engine_tpu_torch.pathtracer.wavefront import trace_pass_soa

    pkey = rng.fold_in(1, 0)
    nd = cfg2.max_bounces + 2  # the camera draw and one per bounce
    wants = {"threefry": [rng.fold_in(pkey, c) for c in range(nd)],
             "pallas": [rng.planes_key(to_int32(rng.key_to_seed(pkey) + c)) for c in range(nd)]}
    kernel = krng.uniform_key
    for mode, want_keys in wants.items():
        calls = []

        def recorded(key, n, h, w, row0=0, band_h=None, device=None):
            out = kernel(key, n, h, w, row0=row0, band_h=band_h, device=device)
            calls.append((rng.key_words(key), (n, h, w, row0, band_h), out))
            return out

        krng.uniform_key = recorded
        try:
            trace_pass_soa(dataclasses.replace(cfg2, rng=mode), scene, pos, quat, key=pkey)
        finally:
            krng.uniform_key = kernel
        keys = [c[0] for c in calls]
        shapes = sorted({c[1] for c in calls})
        same = [torch.equal(out, rng.uniform(k, *shape, device=device))
                for k, shape, out in calls]
        log(f"  {mode}: the {len(calls)} K9 draws of one config-2 pass, shapes (n, h, w, row0, "
            f"band_h) {shapes}: keys as the JAX package derives them {keys == want_keys}; "
            f"kernel == plain version bit for bit {sum(same)}/{len(same)}")
        if keys != want_keys or not all(same):
            raise AssertionError(f"the {mode} pass's K9 draws differ from the plain version "
                                 f"or were drawn under other keys: {keys} != {want_keys}")


def time_c4_routes(quat, c4, device, card):
    """progressive_render at config 4 (pcg) for C4_DEFAULT_CHUNKS chunks of
    16 passes: its default route (render_pt_fast, the plain wavefront with
    the pcg draws) and render_fn=render_pt_mega (K4), by CUDA events."""
    from raytracing_engine_tpu_torch.ops.cuda import pt
    from raytracing_engine_tpu_torch.runtime import ProgressiveState, progressive_render

    cfg, scene, pos = c4
    spp = 16 * C4_DEFAULT_CHUNKS
    out = {}
    for label, fn in (("default route (render_pt_fast)", None),
                      ("render_fn=render_pt_mega (K4)", pt.render_pt_mega)):
        kw = {} if fn is None else {"render_fn": fn}
        state = ProgressiveState.start(cfg, pos, quat, key=1, device=device)
        for state in progressive_render(cfg, scene, state, 1, passes_per_chunk=1, **kw):
            pass  # warm-up
        state = ProgressiveState.start(cfg, pos, quat, key=1, device=device)
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for state in progressive_render(cfg, scene, state, spp, **kw):
            pass
        end.record()
        end.synchronize()
        host_s = time.perf_counter() - t0
        s = start.elapsed_time(end) / 1e3
        out[label] = (s, state.accum.mean().item() / spp)
        log(f"  config 4 {cfg_size(c4)} pcg, progressive_render {label}: {spp} spp "
            f"({C4_DEFAULT_CHUNKS} chunks of 16) in {s:.4f} s by CUDA events ({host_s:.4f} s "
            f"host) = {spp / s:.1f} spp/s, {C4_SPP} spp at this rate {C4_SPP / (spp / s):.2f} s "
            f"(extrapolated) [{card}]")
        if state.spp_done != spp or not torch.isfinite(state.accum).all():
            raise AssertionError(f"config 4 progressive_render {label} incomplete or non-finite")
    (fast_s, fast_mean), (mega_s, mega_mean) = out.values()
    log(f"  config 4: the default route takes {fast_s / mega_s:.1f}x K4's time; image means "
        f"{fast_mean:.6f} and {mega_mean:.6f}")


def phase_rng(quat, c2, c4, c3, bvh3, device, card):
    """K9 against its plain version and JAX's literal values; the threefry
    and pallas render_pt_fast at config 2 under the launch counters, timed;
    bands, progressive_render's default route, the mesh paths."""
    import dataclasses

    from raytracing_engine_tpu_torch.ops import rng
    from raytracing_engine_tpu_torch.ops.cuda import bvh_traverse, cluster, pt
    from raytracing_engine_tpu_torch.ops.cuda import rng as krng
    from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
    from raytracing_engine_tpu_torch.pathtracer.wavefront import render_pt_fast, trace_pass_soa
    from raytracing_engine_tpu_torch.runtime import ProgressiveState, progressive_render
    from raytracing_engine_tpu_torch.utils.timing import rng_bound_ms

    n, h, w = K9_SHAPE
    key = rng.fold_in(1, 0)
    got = krng.uniform_key(key, n, h, w, device=device)
    want = rng.uniform(key, n, h, w, device=device)
    err = (got - want).abs().max().item()
    row0, bh = K9_BAND
    band = krng.uniform_key(key, n, h, w, row0=row0, band_h=bh, device=device)
    band_want = rng.uniform(key, n, h, w, row0=row0, band_h=bh, device=device)
    ok = (torch.equal(got, want) and torch.equal(band, band_want)
          and torch.equal(band, got[:, row0:row0 + bh]))
    log(f"  K9 vs its plain version {K9_SHAPE} bit for bit: {torch.equal(got, want)} "
        f"(max_abs_err {err:.6g}); rows {row0}..{row0 + bh}: kernel == plain "
        f"{torch.equal(band, band_want)}, == rows of the full draw "
        f"{torch.equal(band, got[:, row0:row0 + bh])}; in [0, 1): "
        f"{bool(got.min() >= 0.0) and bool(got.max() < 1.0)}")
    if not ok or not (got.min() >= 0.0 and got.max() < 1.0):
        raise AssertionError("K9 disagrees with its plain version")
    rn, rh_, rw = K9_RAGGED
    rr0, rbh = K9_RAGGED_BAND
    rag = krng.uniform_key(key, rn, rh_, rw, device=device)
    rag_band = krng.uniform_key(key, rn, rh_, rw, row0=rr0, band_h=rbh, device=device)
    okr = (torch.equal(rag, rng.uniform(key, rn, rh_, rw, device=device))
           and torch.equal(rag_band, rng.uniform(key, rn, rh_, rw, rr0, rbh, device=device)))
    before = krng.launches
    empty = (krng.uniform_key(key, 0, rh_, rw, device=device).numel()
             + krng.uniform_key(key, rn, rh_, rw, row0=rr0, band_h=0, device=device).numel())
    log(f"  K9 vs its plain version at {K9_RAGGED} ({rh_ * rw} elements a plane, the last "
        f"block ragged) and rows {rr0}..{rr0 + rbh}, bit for bit: {okr}; empty draws counted "
        f"{krng.launches - before} launches (expected 0)")
    if not okr or empty or krng.launches != before:
        raise AssertionError("K9 disagrees with its plain version on a ragged plane, or an "
                             "empty draw counted a launch")
    for label, u, table in (
            ("jax.random.uniform(PRNGKey(0))", krng.uniform_key(0, n, h, w, device=device),
             JAX_UNIFORM_KEY0),
            ("uniform_planes(-7)", krng.uniform_planes(-7, n, h, w, device=device),
             JAX_PLANES_M7)):
        bits = {i: int(u[i].view(torch.int32).item()) & 0xFFFFFFFF for i in table}
        log(f"  K9 {label} at {len(table)} indices == JAX's: {bits == table}")
        if bits != table:
            raise AssertionError(f"K9 {label} differs from JAX: {bits} != {table}")

    # the slice's main path: render_pt_fast at config 2, threefry then pallas
    cfg2, scene, _ = c2
    zs = [torch.tensor([0.0, 0.0, 1e-3 + 1e-4 * k], device=device) for k in range(RNG_FRAMES)]
    krng.launches = pt.launches = 0
    krng.work["elements"] = 0
    renders, times = {}, {}
    for mode in ("threefry", "pallas"):
        cfg = dataclasses.replace(cfg2, rng=mode)
        renders[mode] = render_pt_fast(cfg, scene, zs[0], quat, C2_SPP, key=1)
        ms, host_ms = cuda_ms(lambda k: render_pt_fast(cfg, scene, zs[k], quat, C2_SPP, key=1),
                              RNG_FRAMES)
        times[mode] = ms
        log(f"  render_pt_fast rng={mode!r} {cfg_size(c2)} {C2_SPP} spp: {ms:.2f} ms/frame "
            f"(host enqueue {host_ms:.2f} ms; the plain wavefront around K9) [{card}]")
    torch.cuda.synchronize(device)
    launches, elements = krng.launches, krng.work["elements"]
    draws = C2_SPP * (cfg2.max_bounces + 2)  # the camera draw and one per bounce, a pass
    want = 2 * (1 + RNG_FRAMES) * draws
    log(f"  K9 launches on the main path {launches} (expected {want}: {draws} per render, "
        f"{1 + RNG_FRAMES} renders per rng mode), {elements} uniforms; K4 launches {pt.launches}")
    if launches != want or pt.launches != 0:
        raise AssertionError(f"K9 launches {launches} != {want} or K4 launched")
    draws_match_plain(cfg2, scene, zs[0], quat, device)

    ref, _ = pt.render_pt_mega(cfg2, scene, zs[0], quat, C2_SPP, seed=seed_from_int(1))
    for mode, (img, nr) in renders.items():
        rel = abs(img.mean().item() / ref.mean().item() - 1.0)
        log(f"  {mode}: finite {bool(torch.isfinite(img).all())}, mean {img.mean().item():.7f} "
            f"against K4's pcg {ref.mean().item():.7f} (relative {rel:.3e}, limit "
            f"{RNG_MEAN_RTOL}), {int(nr)} rays")
        if img.shape != ref.shape or not torch.isfinite(img).all() or rel > RNG_MEAN_RTOL:
            raise AssertionError(f"the {mode} render is off")

    pkey = rng.fold_in(1, 0)
    cfg = dataclasses.replace(cfg2, rng="threefry")
    full, _ = trace_pass_soa(cfg, scene, zs[0], quat, key=pkey)
    r0, rh = RNG_BAND
    part, _ = trace_pass_soa(cfg, scene, zs[0], quat, key=pkey, row0=r0, band_h=rh)
    log(f"  trace_pass_soa rows {r0}..{r0 + rh} == rows of the full pass bit for bit: "
        f"{torch.equal(part, full[r0:r0 + rh])}")
    if not torch.equal(part, full[r0:r0 + rh]):
        raise AssertionError("a threefry band differs from the rows of the full pass")

    # progressive_render's default route: render_pt_fast with the state's key
    time_c4_routes(quat, c4, device, card)
    cfg4 = dataclasses.replace(c4[0], rng="threefry")
    _, scene4, pos4 = c4
    state = ProgressiveState.start(cfg4, pos4, quat, key=1, device=device)
    for state in progressive_render(cfg4, scene4, state, 4, passes_per_chunk=2):
        pass
    one, _ = render_pt_fast(cfg4, scene4, pos4, quat, 4, key=1)
    okc = torch.allclose(state.accum, one * 4.0, rtol=C3_CHUNK_RTOL, atol=0.0)
    log(f"  progressive_render (default route, threefry) {cfg_size((cfg4,))} 2 x 2 spp vs one "
        f"4-spp render_pt_fast (sums) within rtol {C3_CHUNK_RTOL:.3g}: {okc}")
    if state.spp_done != 4 or not okc:
        raise AssertionError("progressive_render's threefry route depends on the chunking")

    _, cs, scene3, cfg3, _ = c3
    cfg3 = dataclasses.replace(cfg3, rng="threefry")
    pos3 = torch.zeros(3, device=device)
    cluster.launches = bvh_traverse.launches = krng.launches = 0
    img, _ = render_pt_fast(cfg3, scene3, pos3, quat, 1, key=1, bvh=cs)
    counts = {"K6": cluster.launches, "K9": krng.launches}
    state = ProgressiveState.start(cfg3, pos3, quat, key=1, device=device)
    for state in progressive_render(cfg3, scene3, state, 1, bvh=bvh3):
        pass
    torch.cuda.synchronize(device)
    counts["K8"], counts["K9"] = bvh_traverse.launches, krng.launches
    nb = cfg3.max_bounces + 1
    wantc = {"K6": 2 * nb, "K9": 2 * (nb + 1), "K8": 2 * nb}
    log(f"  config 3 threefry: render_pt_fast(bvh=cs) and progressive_render(bvh=raw BVH), "
        f"1 spp each: launches {counts} (expected {wantc}); lit "
        f"{(img.amax(-1) > 0).double().mean().item():.4f} and "
        f"{(state.accum.amax(-1) > 0).double().mean().item():.4f}")
    if counts != wantc or not (torch.isfinite(img).all() and torch.isfinite(state.accum).all()):
        raise AssertionError(f"config-3 threefry launch counts {counts} != {wantc}")

    k9_ms, device_ms, plain_ms = time_k9(key, device, card)
    bound = rng_bound_ms(n * h * w)
    log(f"  K9 bound {bound[0]:.5f} ms by {bound[1]} ({n * h * w} uniforms); kernel at "
        f"{bound[0] / k9_ms:.2%} of it by events [{card}]")
    return {"launches": launches, "max_abs_err": err, "ms": k9_ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1]}


# --- phases 17 and 18: the serving surface --------------------------------

class StageClock:
    """Per-stage times of a run: CUDA events around each stage (the device
    time between them on the current stream) and the host clock, each stage
    also annotated for torch.profiler through utils.profiling.stage."""

    def __init__(self):
        self.pairs, self.host, self.calls = {}, {}, {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        from raytracing_engine_tpu_torch.utils import profiling

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        with profiling.stage(name):
            start.record()
            yield
            end.record()
        self.host[name] = self.host.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        self.pairs.setdefault(name, []).append((start, end))
        self.calls[name] = self.calls.get(name, 0) + 1

    def ms(self) -> dict:
        """{stage: (event ms a call, host ms a call)} once the card is done."""
        torch.cuda.synchronize()
        return {n: (sum(s.elapsed_time(e) for s, e in p) / len(p), self.host[n] / len(p))
                for n, p in self.pairs.items()}


def profiled_ms(prof, calls: dict) -> dict:
    """{stage: (kernel ms, span ms) a call} from prof.key_averages(): the
    device time of the kernels and copies that the profiler links to the
    stage's annotation by correlation id, and the annotation's span on the
    card (its gpu_user_annotation row); None where a row is missing or
    empty. The link goes through the aten op that launched a kernel, so
    the kernel time leaves out the port's own kernels (launched through
    ctypes, under no aten op); the span covers them and the card's idle
    gaps between them. calls: {stage: its calls under the profiler}."""
    cpu, dev = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    rows = {(r.key, r.device_type): r.device_time_total / 1e3 for r in prof.key_averages()}
    return {n: tuple(rows[(n, t)] / k if rows.get((n, t)) else None for t in (cpu, dev))
            for n, k in calls.items()}


def log_stages(label, clock, traced, card):
    """One line per stage: CUDA-event and host ms a call, and beside them
    the profiler's device ms a call (traced: profiled_ms's dict)."""
    def fmt(v):
        return f"{v:.4f} ms" if v is not None else "not measured"

    for name, (ev_ms, host_ms) in clock.ms().items():
        kern, span = traced.get(name, (None, None))
        log(f"  {label} stage {name!r}: {ev_ms:.4f} ms by CUDA events, {host_ms:.4f} ms host "
            f"({clock.calls[name]} calls); by the profiler a call: kernels {fmt(kern)}, "
            f"annotation span {fmt(span)} [{card}]")


def replay_stream():
    """REPLAY_EVENTS events: WASD/QE movement with mouse look, the focus lost
    at event 6 and regained at 9 (events 6-8 frozen), the fullscreen toggle
    at 12 (to REPLAY_MONITOR) and at 18 (back)."""
    from raytracing_engine_tpu_torch.runtime import InputEvent

    moves = ((0.0, 1.0, 0.0), (1.0, 0.0, 0.0), (0.0, -1.0, 0.0), (-1.0, 0.0, 1.0))
    looks = ((3.0, -1.0), (-2.0, 0.5), (1.0, 1.0), (0.0, -2.0))
    stream = []
    for k in range(REPLAY_EVENTS):
        if k == 6:
            stream.append(InputEvent(focus=False))
        elif k == 9:
            stream.append(InputEvent(focus=True, rot=(1.0, 0.0), dt=0.01))
        elif k in (12, 18):
            stream.append(InputEvent(fullscreen_toggle=True))
        else:
            stream.append(InputEvent(move=moves[k % 4], cursor=looks[k % 4], dt=0.01))
    return stream


def phase_replay(cfg, scene, card):
    """The cone-march serving path as the JAX package's cmd_replay drives it
    (cli.py:136-179): a FrameLoop run recorded through Recorder, its frames
    written by ApngWriter and VideoWriter (one file each per frame size),
    save_replay / load_replay, and the replay frame by frame and chunked,
    under the launch counters. -> {"K1": n, "K2": n} over the three runs."""
    from raytracing_engine_tpu_torch.models import cuda_renderer
    from raytracing_engine_tpu_torch.ops.cuda import depth, fused, shade
    from raytracing_engine_tpu_torch.runtime import FrameLoop, Recorder, load_replay, save_replay
    from raytracing_engine_tpu_torch.utils import profiling, to_srgb_u8
    from raytracing_engine_tpu_torch.utils.video import (
        ApngWriter,
        VideoWriter,
        read_apng,
        read_y4m,
    )

    SMOKE_OUT.mkdir(exist_ok=True)
    stream = replay_stream()
    clock = StageClock()

    def render(*args):
        with clock("render (K1 + K2)"):
            return cuda_renderer.render(*args)

    writers = {}

    def record_sink(i, img):
        with clock("present: APNG + y4m encode"):
            recorded[i] = img
            if img.shape not in writers:
                stem = SMOKE_OUT / f"replay_{img.shape[1]}x{img.shape[0]}"
                writers[img.shape] = (ApngWriter(f"{stem}.apng", fps=VIDEO_FPS),
                                      VideoWriter(f"{stem}.y4m", fps=VIDEO_FPS), [])
            apng, y4m, order = writers[img.shape]
            apng.add(img)
            y4m.add(img)
            order.append(i)

    def run(events, sink, chunk=None, fn=cuda_renderer.render):
        depth.launches = fused.launches = shade.launches = 0
        loop = FrameLoop(cfg, scene, render_fn=fn, monitor=REPLAY_MONITOR)
        stats = loop.run(events, sink=sink, stats=True, chunk=chunk)
        torch.cuda.synchronize()
        launches = {"K1": depth.launches, "K2": fused.launches, "K3": shade.launches}
        return stats, launches

    recorded = {}
    rec = Recorder()
    with profiling.device_trace(str(SMOKE_OUT / "trace_replay")) as prof:
        rec_stats, rec_launches = run(rec.wrap(stream), record_sink, fn=render)
    for apng, y4m, _ in writers.values():
        apng.close()
        y4m.close()
    path = str(SMOKE_OUT / "session.replay")
    n_saved = save_replay(path, rec.events)
    loaded = load_replay(path)
    if n_saved != REPLAY_EVENTS or loaded != stream:
        raise AssertionError("save_replay / load_replay did not round-trip the stream")

    rendered = [i for i in range(REPLAY_EVENTS) if i not in (6, 7, 8)]
    runs = {"recorded": (rec_stats, rec_launches, recorded)}
    for label, chunk in (("frame by frame", None), (f"chunk={REPLAY_CHUNK}", REPLAY_CHUNK)):
        frames = {}
        stats, launches = run(loaded, lambda i, img: frames.setdefault(i, img), chunk)
        runs[label] = (stats, launches, frames)
    for label, (stats, launches, frames) in runs.items():
        want_idx = rendered if label.startswith("chunk") else list(range(REPLAY_EVENTS))
        want_n = {"K1": len(rendered), "K2": len(rendered), "K3": 0}
        same = all(np.array_equal(frames[i], recorded[i]) for i in frames)
        sizes = sorted({f.shape[:2] for f in frames.values()})
        ms = sum(s.seconds for s in stats) / len(stats) * 1e3
        log(f"  {label}: {len(frames)} frames (events {want_idx == list(frames)}), sizes "
            f"{sizes}, bit for bit the recorded run's: {same}; launches {launches} (expected "
            f"{want_n}); {ms:.3f} ms/frame by FrameLoop's stats (host clock, render and wait) "
            f"[{card}]")
        if list(frames) != want_idx or not same or launches != want_n:
            raise AssertionError(f"the {label} replay differs from the recorded run")
    if not all(np.isfinite(f).all() and f.max() > 0 for f in recorded.values()):
        raise AssertionError("a recorded frame is empty or not finite")

    for shape, (apng, y4m, order) in writers.items():
        want = np.stack([to_srgb_u8(recorded[i]) for i in order])
        got_apng, fps_a = read_apng(apng.path)
        got_y4m, fps_y = read_y4m(y4m.path)
        lsb = int(np.abs(got_y4m.astype(int) - want.astype(int)).max())
        ok = (np.array_equal(got_apng, want) and got_y4m.shape == want.shape and lsb <= Y4M_LSB
              and fps_a == fps_y == VIDEO_FPS)
        log(f"  {shape[1]}x{shape[0]}: {len(order)} frames; APNG read back == to_srgb_u8 "
            f"{np.array_equal(got_apng, want)}, y4m within {lsb} LSB (limit {Y4M_LSB}); "
            f"{Path(apng.path).stat().st_size} and {Path(y4m.path).stat().st_size} bytes")
        if not ok:
            raise AssertionError(f"the {shape} video files do not read back")
    log_stages("replay", clock, profiled_ms(prof, clock.calls), card)
    return {k: sum(r[1][k] for r in runs.values()) for k in ("K1", "K2")}


def flip_share(got: dict, want: dict, tol) -> tuple[int, int, float]:
    """(pixels whose hit flag differs or where a plane leaves tol, pixels,
    max abs error on the others) of two AOV dicts."""
    bad = (got["depth"] > 0) != (want["depth"] > 0)
    errs = []
    for k, w in want.items():
        e = (got[k] - w).abs()
        off = ~torch.isclose(got[k], w, **tol)
        bad |= off.any(-1) if off.ndim == 3 else off
        errs.append(e.amax(-1) if e.ndim == 3 else e)
    keep = ~bad
    err = max(e[keep].max().item() for e in errs) if keep.any() else 0.0
    return int(bad.sum()), bad.numel(), err


def denoise_gain(noisy, out, ref) -> tuple[float, float, float]:
    """tests/test_denoise.py:33-49's three ratios, denoised against noisy:
    tonemapped (x / (1 + x)) MSE, median pixel error, linear MSE."""
    def tm(x):
        return (x / (1.0 + x)).double()

    e_in, e_out = (tm(noisy) - tm(ref)) ** 2, (tm(out) - tm(ref)) ** 2
    med = e_out.mean(-1).median().item() / e_in.mean(-1).median().item()
    lin = ((out - ref) ** 2).double().mean().item() / ((noisy - ref) ** 2).double().mean().item()
    return e_out.mean().item() / e_in.mean().item(), med, lin


def hold_aovs_card(label, cfg, scene, bvh, pos, quat, key, spp=AOV_SPP, ao_radius=AO_RADIUS,
                   got=None):
    """render_aovs on the card (or `got`, its output there) against the
    same call on the CPU; -> the max error where the pixels agree."""
    from raytracing_engine_tpu_torch.pathtracer import render_aovs

    cpu = torch.device("cpu")
    if got is None:
        got = render_aovs(cfg, scene, pos, quat, spp, key, bvh, ao_radius)
    t0 = time.perf_counter()
    want = render_aovs(cfg, scene.to(cpu), pos.cpu(), quat.cpu(), spp, key,
                       bvh.to(cpu) if bvh is not None else None, ao_radius)
    plain_s = time.perf_counter() - t0
    if set(got) != set(want) or not all(torch.isfinite(v).all() for v in got.values()):
        raise AssertionError(f"{label}: AOV planes missing or not finite")
    n_bad, n, err = flip_share(got, {k: v.to(device=pos.device) for k, v in want.items()},
                               AOV_TOL)
    hit = (want["depth"] > 0).double().mean().item()
    limit = math.ceil(FLIP_SHARE * n)
    ao = f", mean AO {want['ao'].mean().item():.4f}" if "ao" in want else ""
    log(f"  (a) render_aovs {cfg.width}x{cfg.height} {spp} spp, AO radius {ao_radius}, "
        f"{label}, card vs CPU: {n_bad} of {n} pixels differ (hit flag or a plane outside "
        f"atol/rtol {AOV_TOL['atol']:g}; limit {limit}), max_abs_err {err:.3g} elsewhere; "
        f"hit share {hit:.3f}{ao}; CPU {plain_s:.1f} s")
    if n_bad > limit or not 0.05 < hit < 1.0:
        raise AssertionError(f"{label}: the card's AOVs differ from the CPU's")
    return err


def aov_instances(device):
    """Two instances of icosphere(2), one rotated and scaled, in front of
    the camera on a floor sphere (materials per instance)."""
    from raytracing_engine_tpu_torch.accel import (
        build_bvh,
        build_clusters,
        icosphere,
        make_instanced_clusters,
        make_instances,
    )
    from raytracing_engine_tpu_torch.pathtracer import DIFFUSE, build_pt_scene

    ico = icosphere(subdivisions=2, radius=1.0)
    rot = np.array([[np.cos(0.7), -np.sin(0.7), 0.0], [np.sin(0.7), np.cos(0.7), 0.0],
                    [0.0, 0.0, 1.0]], np.float32)
    inst = make_instances(build_bvh(ico, device=device),
                          [(np.eye(3, dtype=np.float32), (-0.6, 5.0, 0.0), 1.0),
                           (rot, (1.2, 5.6, 0.3), 0.8)], mats=[0, 1], device=device)
    ic = make_instanced_clusters(inst, build_clusters(ico, device=device), device=device)
    mats = [{"albedo": (0.8, 0.5, 0.3), "kind": DIFFUSE},
            {"albedo": (0.4, 0.7, 0.5), "kind": DIFFUSE},
            {"albedo": (0.5, 0.5, 0.6), "kind": DIFFUSE}]
    scene = build_pt_scene(spheres=[((0.0, 5.0, -51.0), 50.0, 2)], materials=mats,
                           device=device)
    return scene, ic


def orbit_poses(device):
    """ORBIT_POSES poses of ORBIT_PATH around config 3's knot: positions and
    quaternions on the card."""
    from raytracing_engine_tpu_torch.camera import Camera, orbit_path

    positions, rotations = orbit_path(**ORBIT_PATH)
    quats = Camera(positions, rotations).quat()
    return [(positions[i].to(device), quats[i].to(device)) for i in range(ORBIT_POSES)]


def orbit_frame(cfg, scene, cs, state, pos, quat, key, clock):
    """One frame of the denoised temporal orbit (JAX cli.py _pt_orbit with
    --temporal and pt --denoise): (state, accumulated, denoised, aovs)."""
    from raytracing_engine_tpu_torch.ops.cuda import pt
    from raytracing_engine_tpu_torch.pathtracer import (
        denoise,
        render_aovs,
        temporal_noise,
        temporal_step,
    )

    with clock("render_pt_mega (K4)"):
        img, _ = pt.render_pt_mega(cfg, scene, pos, quat, 1, key, bvh=cs)
    with clock("render_aovs (K9 + K6)"):
        aovs = render_aovs(cfg, scene, pos, quat, 1, key, bvh=cs)
    with clock("temporal_step"):
        state, acc = temporal_step(cfg, state, img, aovs, pos, quat)
    with clock("denoise (4 passes)"):
        out = denoise(acc, aovs["albedo"], aovs["normal"], aovs["depth"],
                      noise=temporal_noise(state))
    return state, acc, out, aovs, img


def static_history(cfg, scene, cs, pos, quat, base, device):
    """STATIC_KEYS frames from one pose (K4 at 1 spp and render_aovs, keys
    fold_in(base, 100 + k)) through temporal_step; -> (the frames' inputs
    as dicts of img and the AOV planes, the state, the last output, and
    the reading: the share of hit pixels kept every frame, and over them
    the max of |output - running mean| / max(1, the pixel's largest frame
    value), its absolute error, its pixel (y, x) and that scale)."""
    from raytracing_engine_tpu_torch.ops import rng
    from raytracing_engine_tpu_torch.ops.cuda import pt
    from raytracing_engine_tpu_torch.pathtracer import render_aovs, temporal_init, temporal_step

    state = temporal_init(cfg, device=device)
    frames = []
    for k in range(STATIC_KEYS):
        fkey = rng.fold_in(base, 100 + k)
        img, _ = pt.render_pt_mega(cfg, scene, pos, quat, 1, fkey, bvh=cs)
        aovs = render_aovs(cfg, scene, pos, quat, 1, fkey, bvh=cs)
        state, out = temporal_step(cfg, state, img, aovs, pos, quat)
        frames.append(dict(img=img, **aovs))
    stack = torch.stack([f["img"].double() for f in frames])
    hit = frames[-1]["depth"] > 0
    full = hit & (state.length == float(STATIC_KEYS))
    # MEAN_TOL is tests/test_temporal.py's bound on values up to about 1; a
    # float32 blend rounds relative to the values it blends, and config 3's
    # light and its 1-spp fireflies reach hundreds, so the bound scales with
    # the pixel's largest frame value where that is above 1
    scale = torch.clamp_min(stack.abs().amax(dim=(0, -1)), 1.0)
    error = (out.double() - stack.mean(0)).abs().amax(-1)
    ratio = torch.where(full, error / scale, -1.0)
    at = divmod(int(ratio.argmax()), cfg.width)
    reading = dict(share=full.sum().item() / max(hit.sum().item(), 1), ratio=ratio[at].item(),
                   abs=error[at].item(), at=at, scale=scale[at].item())
    return frames, state, out, reading


def phase_postprocess(c3, bvh3, device, card):
    """The AOV / temporal / denoise path on the card: (a)-(d), then the
    1920x1088 denoised temporal orbit through config 3's ClusterSet under
    the launch counters, timed by stage, its frame 1 held to the plain
    versions. -> (launches of the orbit, K4's max error on its band)."""
    import dataclasses

    from raytracing_engine_tpu_torch.ops import rng
    from raytracing_engine_tpu_torch.ops.cuda import bvh_traverse, cluster, instanced, pt
    from raytracing_engine_tpu_torch.ops.cuda import rng as krng
    from raytracing_engine_tpu_torch.ops.rng import pcg_base_seed
    from raytracing_engine_tpu_torch.pathtracer import (
        PTConfig,
        TemporalState,
        denoise,
        render_aovs,
        render_pt_fast,
        scenes,
        temporal_init,
        temporal_noise,
        temporal_step,
    )
    from raytracing_engine_tpu_torch.utils import (
        ApngWriter,
        profiling,
        read_apng,
        to_srgb_u8,
        tonemap,
    )

    _, cs, scene, _, _ = c3
    origin = torch.zeros(3, device=device)
    ident = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    key = rng.fold_in(1, 0)

    # (a) the AOVs through K9 and each mesh kernel, card against CPU
    small = PTConfig(**AOV_CHECK, rng="pcg")
    cluster.launches = bvh_traverse.launches = instanced.launches = krng.launches = 0
    err = hold_aovs_card("config 3 ClusterSet (K6)", small, scene, cs, origin, ident, key)
    err = max(err, hold_aovs_card("config 3 raw BVH (K8)", small, scene, bvh3, origin, ident,
                                  key))
    iscene, ic = aov_instances(device)
    err = max(err, hold_aovs_card("two icosphere instances (K7)", small, iscene, ic, origin,
                                  ident, key))
    torch.cuda.synchronize()
    counts = {"K6": cluster.launches, "K8": bvh_traverse.launches, "K7": instanced.launches,
              "K9": krng.launches}
    want = {"K6": 2 * AOV_SPP, "K8": 2 * AOV_SPP, "K7": 2 * AOV_SPP, "K9": 3 * AOV_SPP}
    log(f"  (a) launches {counts} (expected {want}: a draw, a closest-hit and an AO launch a "
        f"sample)")
    if counts != want:
        raise AssertionError(f"render_aovs launch counts {counts} != {want}")

    # the orbit: 1920x1088, config 3's ClusterSet, pcg, fold_in(key, i) a frame
    cfg = PTConfig(**C3_HD, rng="pcg")
    poses = orbit_poses(device)
    base = 1  # jax.random.PRNGKey(1)
    clock = StageClock()
    writer = ApngWriter(str(SMOKE_OUT / "orbit_denoised.apng"), fps=VIDEO_FPS)
    frames = []
    state = temporal_init(cfg, device=device)
    states = []
    reset_k4()
    cluster.launches = krng.launches = 0
    t0 = time.perf_counter()
    for i, (pos, quat) in enumerate(poses):
        states.append(state)
        state, acc, out, aovs, img = orbit_frame(cfg, scene, cs, state, pos, quat,
                                                 rng.fold_in(base, i), clock)
        with clock("tonemap + present (host)"):
            frame = tonemap(out.cpu().numpy(), "aces")
        with clock("APNG encode (host)"):
            writer.add(frame)
        frames.append(frame)
        if i == 1:
            keep = dict(state=states[1], img=img, aovs=aovs, acc=acc, out=out, pos=pos,
                        quat=quat, new=state)
    torch.cuda.synchronize()
    orbit_s = time.perf_counter() - t0
    launches = {"K4": pt.launches, "K6": cluster.launches, "K9": krng.launches}
    writer.close()
    want = dict.fromkeys(launches, ORBIT_POSES)
    got, _ = read_apng(writer.path)
    same = np.array_equal(got, np.stack([to_srgb_u8(f) for f in frames]))
    lengths = state.length[state.depth > 0]
    log(f"  orbit {cfg.width}x{cfg.height}, {ORBIT_POSES} poses of {ORBIT_PATH}: "
        f"{orbit_s:.2f} s in all ({orbit_s / ORBIT_POSES * 1e3:.1f} ms a frame, APNG "
        f"included); launches {launches} (expected {want}: one K4, one K9 draw and one K6 a "
        f"frame); APNG read back == to_srgb_u8 of the frames {same}; history at the last "
        f"pose: mean length {lengths.mean().item():.2f}, {(lengths >= 4).double().mean().item():.3f}"
        f" of hit pixels with >= 4 frames [{card}]")
    if launches != want or pt.mesh_launches["clusters"] != ORBIT_POSES or not same:
        raise AssertionError(f"orbit launches {launches} != {want}, or the APNG differs")
    if not all(np.isfinite(f).all() for f in frames):
        raise AssertionError("an orbit frame is not finite")

    # the orbit's frame 1 against plain versions at the full size: its AOVs
    # (K9 + K6) against render_aovs on the CPU, and its K4 render against
    # the plain megakernel on a band of rows at the full width
    key1 = rng.fold_in(base, 1)
    err = max(err, hold_aovs_card("orbit frame 1, config 3 ClusterSet (K9 + K6)", cfg, scene, cs,
                                  keep["pos"], keep["quat"], key1, 1, 0.0, keep["aovs"]))
    row0, band_h = ORBIT_BAND
    band, n_band = pt.render_pt_mega(cfg, scene, keep["pos"], keep["quat"], 1, key1, bvh=cs,
                                     row0=row0, band_h=band_h)
    t0 = time.perf_counter()
    want4, n_want4 = pt.render_pt_mega_reference(
        cfg, scene, keep["pos"], keep["quat"], 1, seed=pcg_base_seed(key=key1), bvh=cs,
        row0=row0, band_h=band_h)
    plain_s = time.perf_counter() - t0
    k4_err = hold_pt(f"K4<clusters> orbit frame 1, rows {row0}..{row0 + band_h} at "
                     f"{cfg.width} columns, vs its plain version (plain {plain_s:.1f} s)",
                     band, n_band, want4, n_want4)
    same = torch.equal(band, keep["img"][row0:row0 + band_h])
    log(f"  the band == the orbit frame's rows bit for bit: {same}")
    if not same:
        raise AssertionError("K4's band differs from the orbit frame's rows")

    # the stages of frame 1 under the profiler (its inputs again), the
    # recorded step after a warm-up one: in a trace that starts with it,
    # its first stage has been seen to get no device row
    traced = StageClock()
    with profiling.device_trace(str(SMOKE_OUT / "trace_orbit"), warmup=1) as prof:
        for _ in range(2):
            orbit_frame(cfg, scene, cs, keep["state"], keep["pos"], keep["quat"], key1, traced)
            torch.cuda.synchronize()
            prof.step()
    log_stages("orbit", clock, profiled_ms(prof, dict.fromkeys(traced.calls, 1)), card)
    kernels = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    log(f"  orbit frame 1 under the profiler: {kernels} device events (kernels and copies)")

    # (b) temporal_step and denoise, card against CPU, on frame 1's planes
    st_cpu = TemporalState(**{k: v.cpu() for k, v in vars(keep["state"]).items()})
    aovs_cpu = {k: v.cpu() for k, v in keep["aovs"].items()}
    t0 = time.perf_counter()
    new_cpu, _ = temporal_step(cfg, st_cpu, keep["img"].cpu(), aovs_cpu,
                                     keep["pos"].cpu(), keep["quat"].cpu())
    t_cpu = time.perf_counter() - t0
    errs = []
    for name in ("irr", "length", "m1", "m2"):
        e, frac = diverging(getattr(keep["new"], name).cpu(), getattr(new_cpu, name), **POST_TOL)
        errs.append((name, e, frac))
    t0 = time.perf_counter()
    den_cpu = denoise(keep["acc"].cpu(), aovs_cpu["albedo"], aovs_cpu["normal"],
                      aovs_cpu["depth"], noise=temporal_noise(keep["new"]).cpu())
    d_cpu = time.perf_counter() - t0
    e_den, f_den = diverging(keep["out"].cpu(), den_cpu, **POST_TOL)
    log(f"  (b) temporal_step (frame 1) card vs CPU: "
        + ", ".join(f"{n} max_abs_err {e:.3g} diverging {f:.3g}" for n, e, f in errs)
        + f"; denoise card vs CPU max_abs_err {e_den:.3g} diverging {f_den:.3g} (atol/rtol "
        f"{POST_TOL['atol']:g}; CPU {t_cpu:.1f} s and {d_cpu:.1f} s)")
    if any(f > 0 for _, _, f in errs) or f_den > 0:
        raise AssertionError("temporal_step or denoise differs between the card and the CPU")
    err = max([err, e_den] + [e for _, e, _ in errs])

    # (c) a static camera: the output is the running mean on full-history
    # pixels, at tests/test_temporal.py's size (see STATIC_SIZE); the same
    # reading at the orbit's size is logged, and a band of its rows around
    # the worst pixel is written for tests/witness_static_hd.py
    pos, quat = poses[0]
    scfg = PTConfig(**STATIC_SIZE, rng="pcg")
    _, _, _, small = static_history(scfg, scene, cs, pos, quat, base, device)
    log(f"  (c) static pose {scfg.width}x{scfg.height}, {STATIC_KEYS} keys: {small['share']:.3f} "
        f"of hit pixels kept every frame (limit > 0.5); output vs running mean there: max "
        f"|error| / max(1, largest frame value) {small['ratio']:.3g} (limit {MEAN_TOL:g}; "
        f"absolute {small['abs']:.3g}, at a pixel whose frames reach {small['scale']:.4g})")
    if small["share"] <= 0.5 or small["ratio"] > MEAN_TOL:
        raise AssertionError("the static-camera history is not the running mean")
    frames_hd, state_hd, out_hd, hd = static_history(cfg, scene, cs, pos, quat, base, device)
    y, x = hd["at"]
    r0 = min(max(y - STATIC_BAND // 2, 0), cfg.height - STATIC_BAND)
    rows = slice(r0, r0 + STATIC_BAND)

    def band(k):
        return torch.stack([f[k][rows] for f in frames_hd]).cpu().numpy()

    np.savez_compressed(
        SMOKE_OUT / "static_hd_band.npz", row0=r0, size=(cfg.width, cfg.height, cfg.max_bounces),
        pos=pos.cpu().numpy(), quat=quat.cpu().numpy(), img=band("img"), albedo=band("albedo"),
        normal=band("normal"), depth=band("depth"), out=out_hd[rows].cpu().numpy(),
        length=state_hd.length[rows].cpu().numpy(), worst=(y, x), ratio=hd["ratio"])
    log(f"  (c) the same at {cfg.width}x{cfg.height} (a reading, no limit): {hd['share']:.3f} of "
        f"hit pixels kept every frame; max |error| / max(1, largest frame value) "
        f"{hd['ratio']:.3g} (absolute {hd['abs']:.3g}) at pixel (y {y}, x {x}), whose frames "
        f"reach {hd['scale']:.4g}; rows {r0}..{r0 + STATIC_BAND} of its inputs written to "
        f"smoke_out/static_hd_band.npz")

    # (d) the denoiser's gain on tests/test_denoise.py:22-49's scene and size:
    # through K4 (pcg, its only stream), and through render_pt_fast at the
    # test's own stream (threefry, K9)
    dcfg = PTConfig(**DENOISE_CHECK, rng="pcg")
    dscene = scenes.cornell_box(device=device)
    dpos = torch.tensor(DENOISE_POS, device=device)
    aovs = render_aovs(dcfg, dscene, dpos, ident, 8, 33)
    runs = {"K4 (pcg)": [pt.render_pt_mega(dcfg, dscene, dpos, ident, spp, key)[0]
                         for spp, key in ((4, 33), (256, 99))]}
    tcfg = dataclasses.replace(dcfg, rng="threefry")
    runs["render_pt_fast (threefry, K9)"] = [
        render_pt_fast(tcfg, dscene, dpos, ident, spp, key)[0] for spp, key in ((4, 33), (256, 99))]
    for label, (noisy, ref) in runs.items():
        out = denoise(noisy, aovs["albedo"], aovs["normal"], aovs["depth"])
        tm_ratio, med, lin = denoise_gain(noisy, out, ref)
        log(f"  (d) cornell_box {dcfg.width}x{dcfg.height} through {label}, 4 spp vs 256: "
            f"tonemapped MSE ratio {tm_ratio:.5f} (limit < 0.65), median pixel error ratio "
            f"{med:.5f} (limit < 0.5), linear MSE ratio {lin:.5f} (limit < 1.15, "
            f"tests/test_denoise.py:49)")
        if not torch.isfinite(out).all() or tm_ratio >= 0.65 or med >= 0.5:
            raise AssertionError(f"the denoiser does not cut the error through {label}")
        if label.startswith("K4"):
            # the linear bound misses on this stream, in the JAX package too:
            # the port's ratio must be JAX's own on the same renders
            log(f"  (d) through K4 the linear ratio {lin:.5f} misses 1.15; the JAX package's "
                f"denoiser on its render_pt_fast at pcg, keys 33 / 99 (the same stream), gives "
                f"{JAX_PCG_LINEAR_RATIO} on the CPU: equal within {LINEAR_RATIO_RTOL:g} "
                f"{abs(lin / JAX_PCG_LINEAR_RATIO - 1.0) <= LINEAR_RATIO_RTOL}")
            if abs(lin / JAX_PCG_LINEAR_RATIO - 1.0) > LINEAR_RATIO_RTOL:
                raise AssertionError("the denoised K4 render's linear error is not JAX's")
        elif lin >= 1.15:
            raise AssertionError(f"the denoiser raises the linear error through {label}")
    return launches, k4_err


# --- phase 19: the showcase scene ---------------------------------------------

def showcase_spec_variant(name: str, edit) -> Path:
    """examples/showcase.json with edit(spec) applied, written to smoke_out/."""
    spec = json.loads(SHOWCASE.read_text())
    edit(spec)
    SMOKE_OUT.mkdir(exist_ok=True)
    path = SMOKE_OUT / f"showcase_{name}.json"
    path.write_text(json.dumps(spec))
    return path


def profiled_device_ms(fn, name: str) -> float | None:
    """Device ms of the kernels whose name holds `name` over one call of fn
    (torch.profiler); None where the profiler records none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    return sum(us) / 1e3 if us else None


def profiled_launches_ms(fn, name: str, n: int, fallback=None) -> float:
    """Device ms of kernel `name` summed over its n launches in one call of
    fn (torch.profiler), tried again where the profiler recorded another
    count (it has dropped a third of 128 events in a window); after three
    tries, fallback() where it is given (k5_events_ms: each launch by CUDA
    events), else the whole call by CUDA events, which adds the launch
    gaps."""
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
        if len(us) == n:
            return sum(us) / 1e3
        counts.append(len(us))
    if fallback is not None:
        ms = fallback()
        log(f"  {name}: the profiler recorded {counts} of {n} launches; each launch by CUDA "
            f"events behind a spin kernel, summed: {ms:.4f} ms")
        return ms
    ms = cuda_ms(lambda k: fn(), 1)[0]
    log(f"  {name}: the profiler recorded {counts} of {n} launches; the whole call by CUDA "
        f"events: {ms:.4f} ms")
    return ms


@contextlib.contextmanager
def correctly_rounded_sqrt():
    """torch.sqrt through float64 (correctly rounded for float32 inputs)."""
    sqrt = torch.sqrt
    torch.sqrt = lambda x: sqrt(x.double()).to(x.dtype)
    try:
        yield
    finally:
        torch.sqrt = sqrt


def phase_showcase(device, card):
    """examples/showcase.json on the card through load_scene_json and a
    smooth ClusterSet (JAX cli.py:312-336): K4's material instantiation
    against its plain version on a band, K5 == K4 there, the whole frame
    timed through render_pt_mega, render_pt_rebin, render_pt_fast and
    progressive_render under the launch counters, the card against the CPU,
    the zero-feature invariants bit for bit, and a PNG; -> the kernels-line
    numbers of the new instantiations and the K6 launches."""
    import dataclasses

    from raytracing_engine_tpu_torch.accel import build_clusters
    from raytracing_engine_tpu_torch.ops.cuda import cluster, pt
    from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
    from raytracing_engine_tpu_torch.pathtracer import PTConfig, load_scene_json
    from raytracing_engine_tpu_torch.pathtracer.wavefront import render_pt_fast, state_plane_count
    from raytracing_engine_tpu_torch.runtime import ProgressiveState, progressive_render
    from raytracing_engine_tpu_torch.utils.image import read_png, to_srgb_u8, tonemap, write_png
    from raytracing_engine_tpu_torch.utils.timing import bound_ms, instanced_ops, k5_bytes, pt_ops

    t0 = time.perf_counter()
    b = load_scene_json(str(SHOWCASE))  # the card: the device rule's default
    scene = b.scene
    cs = build_clusters(b.tris, tri_mats=b.tri_mats, vertex_normals=b.tri_normals)
    pos, quat = torch.from_numpy(b.cam_pos).to(device), torch.from_numpy(b.cam_quat).to(device)
    cfg = PTConfig(**SHOW, rng="pcg")
    seed = seed_from_int(1)
    flags = {k: getattr(scene, k) for k in ("has_metal", "has_aniso", "has_texture",
                                            "has_dispersion", "has_env")}
    log(f"  showcase: {int(scene.sph_count)} spheres, {b.tris.shape[0]} triangles (smooth: "
        f"{cs.smooth}, builder {cs.builder}), {scene.mat_albedo.shape[0]} materials, flags "
        f"{flags}, scene on {scene.device}, material table "
        f"{tuple(pt.pack_pt_scene(scene)[2].shape)}, {state_plane_count(scene)} state planes; "
        f"loaded in {time.perf_counter() - t0:.2f} s")
    if (scene.device.type != "cuda" or not scene.has_material_features
            or state_plane_count(scene) != 18):
        raise AssertionError("the showcase did not load onto the card with its material features")

    # K4 on the band against its plain version; its work gives the bound
    row0, bh = SHOW_BAND
    kw = dict(seed=seed, bvh=cs, row0=row0, band_h=bh)
    reset_k4()
    band, n_band = pt.render_pt_mega(cfg, scene, pos, quat, 1, **kw)
    if pt.material_launches["clusters"] != 1 or pt.mesh_launches["clusters"] != 1:
        raise AssertionError(f"the band took another K4 instantiation: {pt.mesh_launches}, "
                             f"{pt.material_launches}")
    cluster.work.update(slabs=0, tests=0)
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    want, n_want = pt.render_pt_mega_reference(cfg, scene, pos, quat, 1, **kw)
    torch.cuda.synchronize(device)
    plain_ms = (time.perf_counter() - t1) * 1e3
    band_work = dict(cluster.work)  # the band's mesh work: K4's bound, below
    err = hold_pt(f"K4<clusters, material> showcase rows {row0}..{row0 + bh} at {cfg.width} "
                  f"columns, 1 spp, vs its plain version (plain {plain_ms / 1e3:.1f} s)",
                  band, n_band, want, n_want)

    # the material instantiation on a band ragged in both directions, bit for bit
    err = max(err, hold_k4_ragged("the showcase", cfg, scene, cs, pos, quat, seed,
                                  cfg.height // 2 - 3, RAGGED_ROWS))

    # K5 == K4 on the band, bit for bit (the 18-plane state), and K5 against
    # its own plain version there
    before = pt.rebin_material_launches
    rb, n_rb = pt.render_pt_rebin(cfg, scene, pos, quat, 1, **kw)
    same = torch.equal(rb, band) and int(n_rb) == int(n_band)
    log(f"  K5<material> == K4<clusters, material> on the band bit for bit: {same}; rays "
        f"{int(n_rb)} == {int(n_band)}; K5 material launches {pt.rebin_material_launches - before}")
    if not same or pt.rebin_material_launches - before != cfg.max_bounces + 1:
        raise AssertionError("K5 differs from K4 on the showcase band")
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    want_rb, n_want_rb = pt.render_pt_rebin_reference(cfg, scene, pos, quat, 1, **kw)
    torch.cuda.synchronize(device)
    plain_rb_ms = (time.perf_counter() - t1) * 1e3
    k5_err = hold_pt(f"K5<material> showcase rows {row0}..{row0 + bh}, 1 spp, vs its plain "
                     f"version (plain {plain_rb_ms / 1e3:.1f} s)", rb, n_rb, want_rb, n_want_rb)
    log(f"  the plain rebin route == the plain megakernel on the band bit for bit: "
        f"{torch.equal(want_rb, want) and int(n_want_rb) == int(n_want)}")

    # the main path, counted from 0: whole frames through the four entry points
    reset_k4()
    pt.rebin_launches = pt.rebin_material_launches = cluster.launches = 0
    zs = [pos + torch.tensor([0.0, 0.0, 1e-4 * k], device=device) for k in range(SHOW_FRAMES + 1)]
    frame, n_frame = pt.render_pt_mega(cfg, scene, pos, quat, SHOW_SPP, seed=seed, bvh=cs)
    rays = []
    k4_ev, k4_host = cuda_ms(lambda k: rays.append(pt.render_pt_mega(
        cfg, scene, zs[k + 1], quat, SHOW_SPP, seed=seed, bvh=cs)[1]), SHOW_FRAMES)
    n_rays = int(torch.stack(rays).sum()) // SHOW_FRAMES
    rb_rays = []
    pt.render_pt_rebin(cfg, scene, zs[0], quat, SHOW_SPP, seed=seed, bvh=cs)  # warm-up
    k5_ev, k5_host = cuda_ms(lambda k: rb_rays.append(pt.render_pt_rebin(
        cfg, scene, zs[k + 1], quat, SHOW_SPP, seed=seed, bvh=cs)[1]), SHOW_FRAMES)
    n_rb_rays = int(torch.stack(rb_rays).sum()) // SHOW_FRAMES
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t2 = time.perf_counter()
    start.record()
    fast, n_fast = render_pt_fast(cfg, scene, pos, quat, SHOW_SPP, seed=seed, bvh=cs)
    end.record()
    end.synchronize()
    fast_ms, fast_host = start.elapsed_time(end), (time.perf_counter() - t2) * 1e3
    state = ProgressiveState.start(cfg, pos, quat, key=1, device=device)
    for state in progressive_render(cfg, scene, state, SHOW_SPP, passes_per_chunk=SHOW_CHUNK,
                                    bvh=cs, render_fn=pt.render_pt_mega):
        pass
    torch.cuda.synchronize(device)
    counts = {"K4": pt.launches, "K4 material": pt.material_launches["clusters"],
              "K5": pt.rebin_launches, "K5 material": pt.rebin_material_launches,
              "K6": cluster.launches}
    k4_want = 1 + SHOW_FRAMES + SHOW_SPP // SHOW_CHUNK
    k5_want = (1 + SHOW_FRAMES) * SHOW_SPP * (cfg.max_bounces + 1)
    want_counts = {"K4": k4_want, "K4 material": k4_want, "K5": k5_want, "K5 material": k5_want,
                   "K6": 2 * SHOW_SPP * (cfg.max_bounces + 1)}
    log(f"  launches on the showcase's main path {counts} (expected {want_counts}: K4 a "
        f"megakernel frame and a progressive chunk, K5 one a bounce a pass, K6 a closest and a "
        f"shadow sweep a bounce a pass of render_pt_fast)")
    if counts != want_counts:
        raise AssertionError("the showcase's main path took other launches")

    # K4's bound: the band's work at 1 spp scaled to the frame by the rays
    # traced (the frame's rays over the band's), not by rows x spp: the band
    # crosses the spheres and the mesh, where paths are longer than in the
    # sky rows
    scale = n_rays / int(n_want)
    ops = int((pt_ops(int(n_want), int(scene.sph_count), 0)
               + instanced_ops(0, 0, band_work["slabs"], band_work["tests"])) * scale)
    n_bytes = 12 * cfg.width * cfg.height + k4_table_bytes(scene, cs, pos)
    bound = bound_ms(n_bytes, ops)
    log(f"  K4 showcase frame bound {bound[0]:.5f} ms by {bound[1]} ({n_bytes} B; {ops} ops: the "
        f"band's {int(n_want)} rays x {int(scene.sph_count)} spheres, {band_work['slabs']} box "
        f"+ {band_work['tests']} triangle tests, x {scale:.6g} = the frame's {n_rays} rays over "
        f"the band's)")
    k4_ms = device_ms(lambda k: pt.render_pt_mega(cfg, scene, zs[k % (SHOW_FRAMES + 1)], quat,
                                                  SHOW_SPP, seed=seed, bvh=cs),
                      SHOW_FRAMES, "pt_kernel", setup=lambda k: k)
    log(f"  K4 showcase {cfg.width}x{cfg.height} {SHOW_SPP} spp {cfg.max_bounces} bounces: "
        f"{k4_ev:.4f} ms/frame by CUDA events (host enqueue {k4_host:.4f} ms), {k4_ms:.4f} ms of "
        f"device time (the profiler's) = {n_rays / k4_ms / 1e3:.2f} Mrays/s, {n_rays} rays/frame; "
        f"at {bound[0] / k4_ms:.2%} of its bound {bound[0]:.5f} ms [{card}]")
    k5_dev = profiled_device_ms(lambda: pt.render_pt_rebin(cfg, scene, pos, quat, SHOW_SPP,
                                                           seed=seed, bvh=cs), "pt_rebin_kernel")
    if k5_dev is None:
        raise AssertionError("the profiler recorded no pt_rebin_kernel in a showcase frame")
    # K5's bytes from the live rays of each bounce of the same frame's passes
    _, _, run = pt.rebin_bounce_launcher(cfg, scene, pos, quat, seed, cs)
    planes, n_px = state_plane_count(scene), cfg.width * cfg.height
    live = [live_rays(k5_states(run, cfg, s)) for s in range(SHOW_SPP)]
    k5_bytes_frame = sum(k5_bytes(n_px, lv, k4_table_bytes(scene, cs, pos), planes)
                         for lv in live)
    k5_bound = bound_ms(k5_bytes_frame, ops)
    log(f"  render_pt_rebin showcase {cfg.width}x{cfg.height} {SHOW_SPP} spp: {k5_ev:.4f} "
        f"ms/frame by CUDA events (host enqueue {k5_host:.4f} ms) = "
        f"{n_rb_rays / k5_ev / 1e3:.2f} Mrays/s; K5 device time {k5_dev:.4f} ms a frame over "
        f"{SHOW_SPP * (cfg.max_bounces + 1)} launches (the profiler's); K5 bound "
        f"{k5_bound[0]:.5f} ms by {k5_bound[1]} ({k5_bytes_frame} B: {n_px} rays' {planes}-plane "
        f"state written a pass, then the live rays of bounces 1..{cfg.max_bounces} read and "
        f"written, by pass {live}, and the tables; {ops} ops, K4's), at "
        f"{k5_bound[0] / k5_dev:.2%} of it [{card}]")
    log(f"  render_pt_fast(bvh=cs) showcase {cfg.width}x{cfg.height} {SHOW_SPP} spp: "
        f"{fast_ms:.1f} ms/frame by CUDA events ({fast_host:.1f} ms host) = "
        f"{int(n_fast) / fast_ms / 1e3:.2f} Mrays/s [{card}]")
    fast_err = hold_pt(f"render_pt_fast(bvh=cs) rows {row0}..{row0 + bh} of the {SHOW_SPP}-spp "
                       f"frame vs K4's (rays: whole frames)", fast[row0:row0 + bh],
                       n_fast, frame[row0:row0 + bh], n_frame)
    summed = frame * float(SHOW_SPP)
    prog_ok = torch.allclose(state.accum, summed, rtol=2 * SHOW_SPP * 2.0 ** -24, atol=0.0)
    log(f"  progressive_render(bvh=cs, render_fn=render_pt_mega) {SHOW_SPP // SHOW_CHUNK} "
        f"chunks of {SHOW_CHUNK}: within the summation bound of one {SHOW_SPP}-spp render "
        f"{prog_ok} (max_abs_err {(state.accum - summed).abs().max().item():.6g})")
    if state.spp_done != SHOW_SPP or not prog_ok:
        raise AssertionError("progressive_render of the showcase depends on the chunking")

    # the card against the CPU at 64x36
    small = PTConfig(**SHOW_CPU, rng="pcg")
    b_cpu = load_scene_json(str(SHOWCASE), device="cpu")
    cs_cpu = build_clusters(b_cpu.tris, tri_mats=b_cpu.tri_mats, vertex_normals=b_cpu.tri_normals,
                            device="cpu")
    card_img, n_card = pt.render_pt_mega(small, scene, pos, quat, 2, seed=seed, bvh=cs)
    card_img = card_img.cpu()
    args = (small, b_cpu.scene, pos.cpu(), quat.cpu(), 2)
    native, n_native = pt.render_pt_mega(*args, seed=seed, bvh=cs_cpu)
    # PyTorch's float32 sqrt on the CPU is not correctly rounded (about 0.6%
    # of inputs off by one bit); the card's, the kernel's and XLA's are. The
    # check replays the CPU's plain version with a correctly rounded sqrt;
    # where the CPU's own sqrt moves a path, the card must differ from the
    # native CPU render on exactly those pixels
    with correctly_rounded_sqrt():
        cpu_img, n_cpu = pt.render_pt_mega(*args, seed=seed, bvh=cs_cpu)
    cpu_err = hold_pt(f"K4 showcase {small.width}x{small.height} 2 spp on the card vs the plain "
                      f"version on the CPU (correctly rounded sqrt)", card_img, n_card, cpu_img,
                      n_cpu)
    off_card = (card_img - native).abs().amax(-1) > 1e-3
    off_sqrt = (cpu_img - native).abs().amax(-1) > 1e-3
    log(f"  against the CPU's own sqrt: {int(off_card.sum())} pixels off by more than 1e-3 (max "
        f"{(card_img - native).abs().max().item():.6g}), rays {int(n_native)}; the CPU's sqrt "
        f"alone "
        f"moves {int(off_sqrt.sum())} pixels, the same ones: {torch.equal(off_card, off_sqrt)}")
    if not torch.equal(off_card, off_sqrt):
        raise AssertionError("the card differs from the CPU beyond the CPU's sqrt rounding")

    # the zero-feature invariants through K4 (and K5 for the chan plane), bit for bit
    inv = PTConfig(**SHOW_INV, rng="pcg")

    def set_disp(value):
        def edit(spec):
            for m in spec["materials"]:
                if "dispersion" in m:
                    if value is None:
                        del m["dispersion"]
                    else:
                        m["dispersion"] = value
        return edit

    def set_checker(value):
        def edit(spec):
            for m in spec["materials"]:
                if "checker" in m:
                    if value is None:
                        del m["checker"]
                    else:
                        m["checker"]["scale"] = value
        return edit

    checks = []
    for what, zero, none, column in (
            ("dispersion 0", set_disp(0.0), set_disp(None),
             lambda sc: dict(mat_dispersion=torch.zeros_like(sc.mat_ior))),
            ("checker scale 0", set_checker(0.0), set_checker(None),
             lambda sc: dict(mat_albedo2=torch.full_like(sc.mat_albedo, 0.5),
                             mat_tex_scale=torch.zeros_like(sc.mat_ior)))):
        s0 = load_scene_json(str(showcase_spec_variant(what.replace(" ", "_"), zero))).scene
        sn = load_scene_json(str(showcase_spec_variant(what.replace(" ", "_") + "_none",
                                                       none))).scene
        sz = dataclasses.replace(s0, **column(s0))  # the column present and all zero
        imgs = [pt.render_pt_mega(inv, sc, pos, quat, 2, seed=seed, bvh=cs) for sc in (s0, sn, sz)]
        rbs = [pt.render_pt_rebin(inv, sc, pos, quat, 1, seed=seed, bvh=cs)[0] for sc in (s0, sz)]
        ok = (all(torch.equal(i[0], imgs[0][0]) and int(i[1]) == int(imgs[0][1]) for i in imgs)
              and torch.equal(rbs[0], rbs[1]))
        log(f"  invariant {what}: K4 {inv.width}x{inv.height} 2 spp equal bit for bit with the "
            f"key removed and with the column present and zero ({state_plane_count(sz)} state "
            f"planes through K5 too): {ok}")
        checks.append(ok)
    if not all(checks):
        raise AssertionError("a zero feature changed the showcase's render")

    # the picture
    img = frame.cpu().numpy()
    means = img.reshape(-1, 3).mean(0)
    if not np.isfinite(img).all() or not means.min() > 0.0:
        raise AssertionError(f"the showcase frame is non-finite or black: means {means}")
    srgb = tonemap(img, "aces", gamma=2.2)
    write_png(str(SHOW_PNG), srgb)
    back = read_png(str(SHOW_PNG))
    if not np.array_equal(back, to_srgb_u8(srgb)):
        raise AssertionError("the showcase PNG does not read back")
    log(f"  showcase {cfg.width}x{cfg.height} {SHOW_SPP} spp written to {SHOW_PNG.name} (ACES, "
        f"gamma 2.2): finite, channel means {[round(float(m), 5) for m in means]}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"  phase 19 errors: K4 vs plain {err:.6g}, K5 vs plain {k5_err:.6g}, render_pt_fast vs K4 "
        f"{fast_err:.6g}, card vs CPU {cpu_err:.6g}")
    return {
        # plain_ms: each kernel's plain version on the band (SHOW_BAND rows,
        # 1 spp), the part of the frame it replays in this run
        "k4": {"launches": counts["K4 material"], "max_abs_err": err, "ms": k4_ms,
               "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1]},
        "k5": {"launches": counts["K5 material"], "max_abs_err": k5_err, "ms": k5_dev,
               "plain_ms": plain_rb_ms, "bound_ms": k5_bound[0], "bound_by": k5_bound[1]},
        "K6": counts["K6"],
    }


# --- phase 20: the showcase with the rest of the features ----------------------

def showcase_rest_spec(out_dir: Path, unused_only: bool = False) -> Path:
    """examples/showcase.json's dict with the rest of the material features,
    written with its files to out_dir (the example unchanged): the equirect
    HDR sky, a rough-glass sphere, a UV-checkered sphere, the icosphere as an
    OBJ with spherical vt under a PNG texture. unused_only: the showcase
    with a UV-checker and an image material that nothing uses instead."""
    from raytracing_engine_tpu_torch.accel import icosphere, save_obj
    from raytracing_engine_tpu_torch.utils.image import write_png

    spec = json.loads(SHOWCASE.read_text())
    rng = np.random.default_rng(20)
    th, tw = REST_TEX
    tex = np.zeros((th, tw, 3), np.float32)
    tex[...] = (np.arange(th) // 4 % 2)[:, None, None] * np.float32([0.8, 0.3, 0.1])
    tex += (np.arange(tw) // 8 % 2)[None, :, None] * np.float32([0.1, 0.5, 0.8])
    tex = np.clip(tex + rng.uniform(0.0, 0.15, tex.shape), 0.0, 1.0).astype(np.float32)
    write_png(str(out_dir / "tex.png"), tex)
    uv_mat = {"albedo": [0.85, 0.2, 0.15],
              "checker": {"color": [0.1, 0.5, 0.8], "scale": 8, "space": "uv"}}
    if unused_only:
        spec["materials"] += [uv_mat, {"albedo": [0.5, 0.5, 0.5], "image": {"png": "tex.png"}}]
        path = out_dir / "showcase_unused.json"
        path.write_text(json.dumps(spec))
        return path
    H, W = REST_SKY
    theta = (np.arange(H) + 0.5) / H * np.pi  # polar angle from +z, row by row
    phi = ((np.arange(W) + 0.5) / W - 0.5) * 2.0 * np.pi  # u = 0.5 at +x
    bottom, top = (np.float32(spec["env"][k]) for k in ("bottom", "top"))
    t = 0.5 * (np.cos(theta) + 1.0)
    sky = np.broadcast_to((bottom + (top - bottom) * t[:, None])[:, None, :], (H, W, 3)).copy()
    el, radiance, radius = np.radians(REST_SUN[0]), REST_SUN[1], np.radians(REST_SUN[2])
    az = np.radians(60.0)
    sun = np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
    dirs = np.stack([np.sin(theta)[:, None] * np.cos(phi)[None, :],
                     np.sin(theta)[:, None] * np.sin(phi)[None, :],
                     np.broadcast_to(np.cos(theta)[:, None], (H, W))], -1)
    sky[np.arccos(np.clip(dirs @ sun, -1.0, 1.0)) < radius] = radiance
    np.save(str(out_dir / "sky.npy"), sky.astype(np.float32))
    spec["env"] = {"image": "sky.npy", "rows": 32}
    spec["materials"] += [{"kind": "dielectric", "ior": 1.5, "roughness": 0.25}, uv_mat]
    n = len(spec["materials"])
    spec["spheres"] += [{"center": [1.1, 4.3, -0.45], "radius": 0.55, "mat": n - 2},
                        {"center": [-1.3, 4.6, -0.5], "radius": 0.5, "mat": n - 1}]
    ico = spec["meshes"][0]
    ball = icosphere(**ico["icosphere"])
    p = ball / np.linalg.norm(ball, axis=-1, keepdims=True)
    uvs = np.stack([np.arctan2(p[..., 1], p[..., 0]) / (2.0 * np.pi) + 0.5,
                    np.arccos(np.clip(p[..., 2], -1.0, 1.0)) / np.pi], -1).astype(np.float32)
    save_obj(str(out_dir / "ico_uv.obj"), ball, uvs=uvs)
    spec["meshes"] = [{"obj": "ico_uv.obj", "uvs": True, "smooth": True, "mat": ico["mat"],
                       "translate": ico["translate"]}]
    spec["materials"][ico["mat"]]["image"] = {"png": "tex.png"}
    path = out_dir / "showcase_rest.json"
    path.write_text(json.dumps(spec))
    return path


def hold_bitwise(label, got, n_got, want, n_want) -> float:
    """A kernel's render against its plain version, bit for bit; -> the max
    abs error (0)."""
    err = hold_pt(label, got, n_got, want, n_want)
    if not (torch.equal(got, want) and int(n_got) == int(n_want)):
        raise AssertionError(f"{label}: not bit for bit")
    return err


def phase_showcase_rest(device, card):
    """The showcase with the env map, rough glass and UV textures (see the
    module docstring, phase 20); -> the kernels-line numbers of K4's and
    K5's material instantiations on this frame and the K6 launches."""
    import dataclasses
    import tempfile

    from raytracing_engine_tpu_torch.accel import build_clusters
    from raytracing_engine_tpu_torch.ops.cuda import cluster, pt
    from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
    from raytracing_engine_tpu_torch.pathtracer import PTConfig, build_pt_scene, load_scene_json
    from raytracing_engine_tpu_torch.pathtracer.wavefront import (
        _camera_rays,
        render_pt_fast,
        state_plane_count,
    )
    from raytracing_engine_tpu_torch.utils.image import to_srgb_u8, tonemap, write_png
    from raytracing_engine_tpu_torch.utils.timing import (
        bound_ms,
        cluster_table_bytes,
        instanced_ops,
        k5_bytes,
        k6_bytes,
        pt_ops,
        sweep_ops,
    )

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    out_dir = Path(tmp.name)
    b = load_scene_json(str(showcase_rest_spec(out_dir)))  # the card: the default
    scene = b.scene
    cs = build_clusters(b.tris, tri_mats=b.tri_mats, vertex_normals=b.tri_normals,
                        vertex_uvs=b.tri_uvs)
    pos, quat = torch.from_numpy(b.cam_pos).to(device), torch.from_numpy(b.cam_quat).to(device)
    seed = seed_from_int(1)
    flags = {k: bool(getattr(scene, k)) for k in (
        "has_env_map", "has_rough_dielectric", "needs_uv", "has_image", "has_tri_uv",
        "has_metal", "has_texture", "has_dispersion", "has_env")}
    log(f"  showcase with the rest: {int(scene.sph_count)} spheres, {b.tris.shape[0]} triangles "
        f"(UV table {cs.has_uv}, smooth {cs.smooth}), {scene.mat_albedo.shape[0]} materials, "
        f"material table {tuple(pt.pack_pt_scene(scene)[2].shape)}, env map "
        f"{tuple(scene.env_img.shape)} pick {float(scene.env_pick):.6g}, atlas "
        f"{tuple(scene.tex_atlas.shape)}, flags {flags}; loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    if (scene.device.type != device.type or not cs.has_uv
            or flags != {k: k != "has_env" for k in flags}):
        raise AssertionError("the scene did not load onto the card with its features")

    # K4 and K5 on the band, nearest and bilinear, bit for bit with the plain versions
    row0, bh = SHOW_BAND
    kw = dict(seed=seed, bvh=cs, row0=row0, band_h=bh)
    errs, k5_errs = [], []
    for filt in ("nearest", "bilinear"):
        cfg = PTConfig(**SHOW, rng="pcg", tex_filter=filt)
        reset_k4()
        band, n_band = pt.render_pt_mega(cfg, scene, pos, quat, 1, **kw)
        if pt.material_launches["clusters"] != 1:
            raise AssertionError(f"the band took another K4 instantiation: {pt.mesh_launches}")
        cluster.work.update(slabs=0, tests=0)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        want, n_want = pt.render_pt_mega_reference(cfg, scene, pos, quat, 1, **kw)
        torch.cuda.synchronize(device)
        plain_ms = (time.perf_counter() - t1) * 1e3
        band_work, band_rays = dict(cluster.work), int(n_want)
        errs.append(hold_bitwise(f"K4<clusters, material> rows {row0}..{row0 + bh}, 1 spp, "
                                 f"{filt}, vs its plain version (plain {plain_ms / 1e3:.2f} s)",
                                 band, n_band, want, n_want))
        before = pt.rebin_material_launches
        rb, n_rb = pt.render_pt_rebin(cfg, scene, pos, quat, 1, **kw)
        same = torch.equal(rb, band) and int(n_rb) == int(n_band)
        log(f"  K5<material> == K4<clusters, material> on the band ({filt}) bit for bit: "
            f"{same}; K5 material launches {pt.rebin_material_launches - before}")
        if not same or pt.rebin_material_launches - before != cfg.max_bounces + 1:
            raise AssertionError("K5 differs from K4 on the band")
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        want_rb, n_want_rb = pt.render_pt_rebin_reference(cfg, scene, pos, quat, 1, **kw)
        torch.cuda.synchronize(device)
        plain_rb_ms = (time.perf_counter() - t1) * 1e3
        k5_errs.append(hold_bitwise(f"K5<material> rows {row0}..{row0 + bh}, 1 spp, {filt}, vs "
                                    f"its plain version (plain {plain_rb_ms / 1e3:.2f} s)",
                                    rb, n_rb, want_rb, n_want_rb))
    cfg = PTConfig(**SHOW, rng="pcg", tex_filter="bilinear")

    # K6's UV planes on the frame's camera rays, bit for bit with the plain sweep
    half = torch.full((cfg.height, cfg.width), 0.5, device=device)
    o, d = _camera_rays(cfg, pos, quat, half, half)
    o, d = tuple(x.contiguous() for x in o), tuple(x.contiguous() for x in d)
    fc = pt.frame_view(cs, pos)
    okw = dict(attrs=True, order=fc.orders[0], orders=fc.orders, refs=fc.refs)
    got = cluster.cluster_intersect(cs, o, d, float("inf"), **okw)
    cluster.work.update(slabs=0, tests=0)
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    want = cluster.cluster_intersect_reference(cs, o, d, float("inf"), **okw)
    torch.cuda.synchronize(device)
    k6_plain_ms = (time.perf_counter() - t1) * 1e3
    k6_work = dict(cluster.work)
    same = len(got) == len(want) == 9 and all(torch.equal(g, w) for g, w in zip(got, want))
    hits = int((want[1] >= 0).sum())
    log(f"  K6 on the frame's {o[0].numel()} camera rays, closest + attributes on the UV table: "
        f"nine planes bit for bit with the plain sweep {same} ({hits} hits; u in "
        f"[{want[7][want[1] >= 0].min().item():.4f}, {want[7][want[1] >= 0].max().item():.4f}]; "
        f"plain {k6_plain_ms:.1f} ms)")
    if not same or hits == 0:
        raise AssertionError("K6's UV planes differ from the plain sweep")
    k6_ms = device_ms(lambda k: cluster.cluster_intersect(cs, o, d, float("inf"), **okw), 8,
                      "cluster_kernel")
    tb = cluster.sweep_tables(cs)
    k6_tables = cluster_table_bytes([tb.sbox, tb.crec, tb.trec, tb.tsmooth, tb.tuv, fc.orders,
                                     fc.refs])
    k6_bound = bound_ms(k6_bytes(o[0].numel(), True, k6_tables) + 8 * o[0].numel(),
                        sweep_ops(k6_work["slabs"], k6_work["tests"]))
    log(f"  K6<uv> frame camera rays: {k6_ms:.4f} ms of device time (the profiler's); bound "
        f"{k6_bound[0]:.5f} ms by {k6_bound[1]} ({k6_work['slabs']} box + {k6_work['tests']} "
        f"triangle tests; 9 planes out) = {k6_bound[0] / k6_ms:.2%} [{card}]")

    # the main path, counted from 0: whole frames through the three entry points
    reset_k4()
    pt.rebin_launches = pt.rebin_material_launches = cluster.launches = 0
    zs = [pos + torch.tensor([0.0, 0.0, 1e-4 * k], device=device) for k in range(SHOW_FRAMES + 1)]
    frame, n_frame = pt.render_pt_mega(cfg, scene, pos, quat, SHOW_SPP, seed=seed, bvh=cs)
    rays = []
    k4_ev, k4_host = cuda_ms(lambda k: rays.append(pt.render_pt_mega(
        cfg, scene, zs[k + 1], quat, SHOW_SPP, seed=seed, bvh=cs)[1]), SHOW_FRAMES)
    n_rays = int(torch.stack(rays).sum()) // SHOW_FRAMES
    rb_frame, n_rb_frame = pt.render_pt_rebin(cfg, scene, pos, quat, SHOW_SPP, seed=seed, bvh=cs)
    fast, n_fast = render_pt_fast(cfg, scene, pos, quat, SHOW_SPP, seed=seed, bvh=cs)
    torch.cuda.synchronize(device)
    counts = {"K4": pt.launches, "K4 material": pt.material_launches["clusters"],
              "K5": pt.rebin_launches, "K5 material": pt.rebin_material_launches,
              "K6": cluster.launches}
    want_counts = {"K4": 1 + SHOW_FRAMES, "K4 material": 1 + SHOW_FRAMES,
                   "K5": SHOW_SPP * (cfg.max_bounces + 1),
                   "K5 material": SHOW_SPP * (cfg.max_bounces + 1),
                   "K6": 2 * SHOW_SPP * (cfg.max_bounces + 1)}
    log(f"  launches on the main path {counts} (expected {want_counts}: K4 a frame, K5 one a "
        f"bounce a pass, K6 a closest and a shadow sweep a bounce a pass of render_pt_fast)")
    if counts != want_counts:
        raise AssertionError("the main path took other launches")
    same = torch.equal(rb_frame, frame) and int(n_rb_frame) == int(n_frame)
    log(f"  render_pt_rebin == render_pt_mega on the whole {SHOW_SPP}-spp frame bit for bit: "
        f"{same}")
    if not same:
        raise AssertionError("K5 differs from K4 on the frame")
    fast_err = hold_pt(f"render_pt_fast(bvh=cs) rows {row0}..{row0 + bh} of the frame vs K4's "
                       "(rays: whole frames)", fast[row0:row0 + bh], n_fast,
                       frame[row0:row0 + bh], n_frame)

    # times and bounds: the band's work at 1 spp scaled to the frame by the rays
    scale = n_rays / band_rays
    ops = int((pt_ops(band_rays, int(scene.sph_count), 0)
               + instanced_ops(0, 0, band_work["slabs"], band_work["tests"])) * scale)
    feats = sum(4 * t.numel() for t in pt.feature_tables(pt.kernel_scene(scene, cs)).values()
                if t is not None)
    tables = k4_table_bytes(scene, cs, pos) + 4 * tb.tuv.numel() + feats
    n_bytes = 12 * cfg.width * cfg.height + tables
    bound = bound_ms(n_bytes, ops)
    k4_ms = device_ms(lambda k: pt.render_pt_mega(cfg, scene, zs[k % (SHOW_FRAMES + 1)], quat,
                                                  SHOW_SPP, seed=seed, bvh=cs),
                      SHOW_FRAMES, "pt_kernel", setup=lambda k: k)
    log(f"  K4<clusters, material> {cfg.width}x{cfg.height} {SHOW_SPP} spp {cfg.max_bounces} "
        f"bounces, bilinear: {k4_ev:.4f} ms/frame by CUDA events (host enqueue {k4_host:.4f} "
        f"ms), {k4_ms:.4f} ms of device time (the profiler's) = {n_rays / k4_ms / 1e3:.2f} "
        f"Mrays/s, {n_rays} rays/frame; bound {bound[0]:.5f} ms by {bound[1]} ({n_bytes} B; "
        f"{ops} ops: the band's {band_rays} rays x {int(scene.sph_count)} spheres, "
        f"{band_work['slabs']} box + {band_work['tests']} triangle tests, x {scale:.6g}) = "
        f"{bound[0] / k4_ms:.2%} [{card}]")
    k5_dev = profiled_device_ms(lambda: pt.render_pt_rebin(cfg, scene, pos, quat, SHOW_SPP,
                                                           seed=seed, bvh=cs), "pt_rebin_kernel")
    if k5_dev is None:
        raise AssertionError("the profiler recorded no pt_rebin_kernel in a frame")
    _, _, run = pt.rebin_bounce_launcher(cfg, scene, pos, quat, seed, cs)
    planes, n_px = state_plane_count(scene), cfg.width * cfg.height
    live = [live_rays(k5_states(run, cfg, s)) for s in range(SHOW_SPP)]
    k5_bytes_frame = sum(k5_bytes(n_px, lv, tables, planes) for lv in live)
    k5_bound = bound_ms(k5_bytes_frame, ops)
    log(f"  K5<material> frame: {k5_dev:.4f} ms of device time over "
        f"{SHOW_SPP * (cfg.max_bounces + 1)} launches (the profiler's); bound "
        f"{k5_bound[0]:.5f} ms by {k5_bound[1]} ({k5_bytes_frame} B: the {planes}-plane state "
        f"of the live rays {live} and the tables) = {k5_bound[0] / k5_dev:.2%} [{card}]")

    # the card against the CPU at 64x36, within the megakernel bounds
    small = PTConfig(**SHOW_CPU, rng="pcg", tex_filter="bilinear")
    b_cpu = load_scene_json(str(out_dir / "showcase_rest.json"), device="cpu")
    cs_cpu = build_clusters(b_cpu.tris, tri_mats=b_cpu.tri_mats, vertex_normals=b_cpu.tri_normals,
                            vertex_uvs=b_cpu.tri_uvs, device="cpu")
    card_img, n_card = pt.render_pt_mega(small, scene, pos, quat, 2, seed=seed, bvh=cs)
    with correctly_rounded_sqrt():
        cpu_img, n_cpu = pt.render_pt_mega(small, b_cpu.scene, pos.cpu(), quat.cpu(), 2,
                                           seed=seed, bvh=cs_cpu)
    cpu_err = hold_pt(f"K4 {small.width}x{small.height} 2 spp on the card vs the plain version on "
                      "the CPU (correctly rounded sqrt)", card_img.cpu(), n_card, cpu_img, n_cpu)

    # K4<none, material> on unrolled slots with tri_uvs, bit for bit
    rng = np.random.default_rng(21)
    inv = PTConfig(**SHOW_INV, rng="pcg")
    slots = build_pt_scene(
        spheres=[((0.0, 8.0, -1001.0), 1000.0, 0), ((-1.5, 6.0, 0.0), 1.0, 1),
                 ((3.0, 4.0, 3.0), 0.5, 3)],
        materials=[{"albedo": (0.7, 0.7, 0.65)},
                   {"albedo": (0.8, 0.2, 0.2),
                    "checker": {"color": (0.1, 0.6, 0.2), "scale": 8.0, "space": "uv"}},
                   {"image": {"pixels": rng.uniform(0.0, 1.0, (6, 10, 3)), "scale": 2.0}},
                   {"albedo": (0.0, 0.0, 0.0), "emission": (20.0, 18.0, 15.0)}],
        triangles=np.float32([[[-1, 9, -1], [1, 9, -1], [1, 9, 1]],
                              [[-1, 9, -1], [1, 9, 1], [-1, 9, 1]]]),
        tri_mats=np.int32([2, 2]), tri_uvs=np.float32([[[0, 0], [1, 0], [1, 1]],
                                                       [[0, 0], [1, 1], [0, 1]]]),
        device=device)
    for filt in ("nearest", "bilinear"):
        c = dataclasses.replace(inv, tex_filter=filt)
        reset_k4()
        got_s, n_s = pt.render_pt_mega(c, slots, pos, quat, 2, seed=seed)
        if pt.material_launches["none"] != 1:
            raise AssertionError("the slots scene took another K4 instantiation")
        errs.append(hold_bitwise(f"K4<none, material> unrolled slots with tri_uvs "
                                 f"{c.width}x{c.height} 2 spp, {filt}, vs its plain version",
                                 got_s, n_s, *pt.render_pt_mega_reference(c, slots, pos, quat,
                                                                          2, seed=seed)))

    # the zero invariants through K4 (and K5), bit for bit
    spec = json.loads((out_dir / "showcase_rest.json").read_text())
    for m in spec["materials"]:
        if m.get("roughness") == 0.25:
            m["roughness"] = 0.0
    (out_dir / "rough0.json").write_text(json.dumps(spec))
    for m in spec["materials"]:
        if m.get("kind") == "dielectric" and "roughness" in m:
            del m["roughness"]
    (out_dir / "nokey.json").write_text(json.dumps(spec))
    s0 = load_scene_json(str(out_dir / "rough0.json")).scene
    sn = load_scene_json(str(out_dir / "nokey.json")).scene
    sf = dataclasses.replace(s0, has_rough_dielectric=True)  # the branch on, every roughness 0
    imgs = [pt.render_pt_mega(inv, sc, pos, quat, 2, seed=seed, bvh=cs) for sc in (s0, sn, sf)]
    rbs = [pt.render_pt_rebin(inv, sc, pos, quat, 1, seed=seed, bvh=cs)[0] for sc in (s0, sf)]
    ok_rough = (not s0.has_rough_dielectric and all(
        torch.equal(i[0], imgs[0][0]) and int(i[1]) == int(imgs[0][1]) for i in imgs)
        and torch.equal(rbs[0], rbs[1]))
    show = load_scene_json(str(SHOWCASE))
    unused = load_scene_json(str(showcase_rest_spec(out_dir, unused_only=True))).scene
    kw_mesh = dict(tri_mats=show.tri_mats, vertex_normals=show.tri_normals)
    cs_show = build_clusters(show.tris, **kw_mesh)
    cs_uv = build_clusters(show.tris, vertex_uvs=np.zeros((len(show.tris), 3, 2), np.float32),
                           **kw_mesh)  # the same sweeps, with UV rows
    a, na = pt.render_pt_mega(inv, show.scene, pos, quat, 2, seed=seed, bvh=cs_show)
    u, nu = pt.render_pt_mega(inv, unused, pos, quat, 2, seed=seed, bvh=cs_uv)
    ok_unused = unused.needs_uv and unused.has_image and torch.equal(a, u) and int(na) == int(nu)
    log(f"  invariants at {inv.width}x{inv.height}: roughness 0 == the glass without the key == "
        f"the rough-glass branch forced on (K4 2 spp, K5 1 spp) bit for bit {ok_rough}; unused "
        f"UV-checker and image materials (UV table, atlas) == the showcase bit for bit "
        f"{ok_unused}")
    if not (ok_rough and ok_unused):
        raise AssertionError("a zero or unused feature changed the render")

    # the picture
    img = frame.cpu().numpy()
    means = img.reshape(-1, 3).mean(0)
    if not np.isfinite(img).all() or not means.min() > 0.0:
        raise AssertionError(f"the frame is non-finite or black: means {means}")
    srgb = tonemap(img, "aces", gamma=2.2)
    SMOKE_OUT.mkdir(exist_ok=True)
    write_png(str(REST_PNG), srgb)
    tmp.cleanup()
    log(f"  frame {cfg.width}x{cfg.height} {SHOW_SPP} spp written to {REST_PNG.name}: finite, "
        f"channel means {[round(float(m), 5) for m in means]}; bytes {to_srgb_u8(srgb).nbytes}; "
        f"phase {time.perf_counter() - t0:.1f} s")
    log(f"  phase 20 errors: K4 vs plain {max(errs):.6g}, K5 vs plain {max(k5_errs):.6g}, "
        f"render_pt_fast vs K4 {fast_err:.6g}, card vs CPU {cpu_err:.6g}")
    return {
        # plain_ms: each kernel's plain version on the band (SHOW_BAND rows,
        # 1 spp, bilinear), the part of the frame it replays in this run
        "k4": {"launches": counts["K4 material"], "max_abs_err": max(errs), "ms": k4_ms,
               "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1]},
        "k5": {"launches": counts["K5 material"], "max_abs_err": max(k5_errs), "ms": k5_dev,
               "plain_ms": plain_rb_ms, "bound_ms": k5_bound[0], "bound_by": k5_bound[1]},
        "K6": counts["K6"],
    }


# --- phase 22: the texture features ---------------------------------------------

def tex_images(seed: int = 22):
    """(albedo (16, 64, 3), normal map (16, 32, 3) holding (n + 1) / 2): a
    stripe pattern with noise, and bumps tilted by up to TEX_BUMPS."""
    rng = np.random.default_rng(seed)
    th, tw = TEX_ALBEDO
    tex = ((np.arange(th) // 2 % 2)[:, None, None] * np.float32([0.7, 0.2, 0.1])
           + (np.arange(tw) // 4 % 2)[None, :, None] * np.float32([0.1, 0.4, 0.7]))
    tex = np.clip(tex + rng.uniform(0.05, 0.2, tex.shape), 0.0, 1.0).astype(np.float32)
    nh, nw = TEX_NORMAL
    y, x = np.mgrid[0:nh, 0:nw].astype(np.float32)
    n = np.stack([TEX_BUMPS * np.sin(x * 0.8) * np.cos(y * 0.6),
                  TEX_BUMPS * np.cos(x * 0.5 + y * 0.9), np.ones_like(x)], -1)
    n = n + rng.normal(0.0, 0.03, n.shape)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return tex, ((n + 1.0) * 0.5).astype(np.float32)


def textures_spec(out_dir: Path) -> Path:
    """Phase 20's showcase (showcase_rest_spec) with its UV icosphere
    normal-mapped and its image a 16 x 64 texture with its mip chain
    (tex_mips)."""
    from raytracing_engine_tpu_torch.utils.image import write_png

    spec = json.loads(showcase_rest_spec(out_dir).read_text())
    tex, nrm = tex_images()
    write_png(str(out_dir / "tex16.png"), tex)
    np.save(str(out_dir / "nrm.npy"), nrm)
    m = spec["materials"][spec["meshes"][0]["mat"]]
    m["image"] = {"png": "tex16.png", "scale": 2}
    m["normal"] = {"npy": "nrm.npy", "scale": 2}
    spec["tex_mips"] = True
    path = out_dir / "textures.json"
    path.write_text(json.dumps(spec))
    return path


def tex_instances(device):
    """(d)'s scene: config 5's grid (C5_GRID) of a UV icosphere (spherical
    UVs) with per-instance materials 0 (image with its mip chain and a
    normal map), 1 (a normal map) and 2 (flat), a sphere light and a floor;
    -> (scene, InstancedClusters, the base ClusterSet)."""
    from raytracing_engine_tpu_torch.accel import (
        build_bvh,
        build_clusters,
        grid_instances,
        icosphere,
        make_instanced_clusters,
    )
    from raytracing_engine_tpu_torch.pathtracer import build_pt_scene

    ball = icosphere(**TEX_BASE).astype(np.float32)
    p = ball / np.linalg.norm(ball, axis=-1, keepdims=True)
    uvs = np.stack([np.arctan2(p[..., 1], p[..., 0]) / (2.0 * np.pi) + 0.5,
                    np.arccos(np.clip(p[..., 2], -1.0, 1.0)) / np.pi], -1).astype(np.float32)
    tex, nrm = tex_images(23)
    scene = build_pt_scene(
        spheres=[((8.0, 2.0, 10.0), 2.0, 3), ((0.0, 14.0, -103.0), 100.0, 4)],
        materials=[{"albedo": (0.75, 0.5, 0.3), "image": {"pixels": tex, "scale": 2.0},
                    "normal": {"pixels": nrm, "scale": 3.0}},
                   {"albedo": (0.4, 0.7, 0.5), "normal": nrm},
                   {"albedo": (0.5, 0.5, 0.8)},
                   {"albedo": (0, 0, 0), "emission": (40.0, 38.0, 34.0)},
                   {"albedo": (0.55, 0.55, 0.5)}], tex_mips=True, device=device)
    cs = build_clusters(ball, vertex_uvs=uvs, device=device)
    inst = grid_instances(build_bvh(ball, device=device), **C5_GRID,
                          mats=np.arange(30, dtype=np.int32) % 3, device=device)
    return scene, make_instanced_clusters(inst, cs, scene=scene, device=device), cs


def hold_planes(label, got, want, n_planes) -> int:
    """Every output plane of a sweep kernel against its plain version, bit
    for bit; -> the hits."""
    same = len(got) == len(want) == n_planes and all(torch.equal(g, w) for g, w in zip(got, want))
    hits = int((want[1] >= 0).sum())
    log(f"  {label}: {n_planes} planes bit for bit with the plain sweep {same} ({hits} hits)")
    if not same or hits == 0:
        raise AssertionError(f"{label}: the planes differ from the plain sweep")
    return hits


def phase_textures(device, card):
    """The texture features (module docstring, phase 22); -> the kernels-line
    entries of the new instantiations."""
    import tempfile

    from raytracing_engine_tpu_torch.accel import build_clusters
    from raytracing_engine_tpu_torch.ops.cuda import cluster, instanced, pt
    from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
    from raytracing_engine_tpu_torch.pathtracer import PTConfig, load_scene_json
    from raytracing_engine_tpu_torch.pathtracer.wavefront import (
        _camera_rays,
        render_pt_fast,
        state_plane_count,
    )
    from raytracing_engine_tpu_torch.utils.image import tonemap, write_png
    from raytracing_engine_tpu_torch.utils.timing import (
        bound_ms,
        cluster_table_bytes,
        instanced_ops,
        k5_bytes,
        k6_bytes,
        k7_bytes,
        pt_ops,
        sweep_ops,
    )

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    out_dir = Path(tmp.name)
    b = load_scene_json(str(textures_spec(out_dir)))
    scene = b.scene
    cs = build_clusters(b.tris, tri_mats=b.tri_mats, vertex_normals=b.tri_normals,
                        vertex_uvs=b.tri_uvs)
    pos, quat = torch.from_numpy(b.cam_pos).to(device), torch.from_numpy(b.cam_quat).to(device)
    seed = seed_from_int(1)
    log(f"  textures scene: {b.tris.shape[0]} triangles (UV table {cs.has_uv}), atlas "
        f"{tuple(scene.tex_atlas.shape)}, {scene.n_mip_levels} mip levels, normal map "
        f"{scene.has_normal_map}, material table {tuple(pt.pack_pt_scene(scene)[2].shape)}; "
        f"loaded in {time.perf_counter() - t0:.2f} s")
    if not (scene.needs_tan and scene.has_mips and scene.has_normal_map and cs.has_uv
            and scene.device.type == device.type):
        raise AssertionError("the textures scene did not load onto the card with its features")
    cfg = PTConfig(**SHOW, rng="pcg", tex_filter="trilinear")
    half = torch.full((cfg.height, cfg.width), 0.5, device=device)
    o, d = _camera_rays(cfg, pos, quat, half, half)
    o, d = tuple(x.contiguous() for x in o), tuple(x.contiguous() for x in d)
    n_rays = o[0].numel()

    # (a) K6's tangent planes on the frame's camera rays
    fc = pt.frame_view(cs, pos)
    okw = dict(attrs=True, order=fc.orders[0], orders=fc.orders, refs=fc.refs, tan=True)
    cluster.launches = cluster.tan_launches = 0
    got = cluster.cluster_intersect(cs, o, d, float("inf"), **okw)
    k6_launches = cluster.tan_launches
    if (cluster.launches, k6_launches) != (1, 1):
        raise AssertionError(f"cluster_intersect(tan=True) took other launches: "
                             f"{cluster.launches}, {k6_launches}")
    cluster.work.update(slabs=0, tests=0)
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    want = cluster.cluster_intersect_reference(cs, o, d, float("inf"), **okw)
    torch.cuda.synchronize(device)
    k6_plain_ms = (time.perf_counter() - t1) * 1e3
    k6_work = dict(cluster.work)
    hold_planes(f"K6<uv, tan> on the frame's {n_rays} camera rays", got, want, 12)
    hit = want[1] >= 0
    tl = torch.sqrt(want[9] ** 2 + want[10] ** 2 + want[11] ** 2)[hit]
    log(f"  K6 tangent lengths on the hits: {tl.min().item():.4g} .. {tl.max().item():.4g}")
    k6_ms = device_ms(lambda k: cluster.cluster_intersect(cs, o, d, float("inf"), **okw), 8,
                      "cluster_kernel")
    tb = cluster.sweep_tables(cs)
    k6_tables = cluster_table_bytes([tb.sbox, tb.crec, tb.trec, tb.tsmooth, tb.tuv, fc.orders,
                                     fc.refs])
    k6_bound = bound_ms(k6_bytes(n_rays, True, k6_tables, uv=True, tan=True) + 8 * n_rays,
                        sweep_ops(k6_work["slabs"], k6_work["tests"]))
    log(f"  K6<uv, tan> frame camera rays: {k6_ms:.4f} ms of device time (the profiler's); "
        f"plain {k6_plain_ms:.1f} ms; bound {k6_bound[0]:.5f} ms by {k6_bound[1]} "
        f"({k6_work['slabs']} box + {k6_work['tests']} triangle tests; 12 planes out) = "
        f"{k6_bound[0] / k6_ms:.2%} [{card}]")

    # (c) K4 and K5's texture instantiations on the band, bit for bit
    row0, bh = SHOW_BAND
    kw = dict(seed=seed, bvh=cs, row0=row0, band_h=bh)
    errs, k5_errs = [], []
    for filt in ("trilinear", "bilinear"):
        c = PTConfig(**SHOW, rng="pcg", tex_filter=filt)
        reset_k4()
        band, n_band = pt.render_pt_mega(c, scene, pos, quat, 1, **kw)
        if pt.tex_launches["clusters"] != 1:
            raise AssertionError(f"the band took another K4 instantiation: {pt.tex_launches}")
        cluster.work.update(slabs=0, tests=0)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        want, n_want = pt.render_pt_mega_reference(c, scene, pos, quat, 1, **kw)
        torch.cuda.synchronize(device)
        if filt == "trilinear":
            plain_ms, band_work, band_rays = ((time.perf_counter() - t1) * 1e3,
                                              dict(cluster.work), int(n_want))
        errs.append(hold_bitwise(f"K4<clusters, tex> rows {row0}..{row0 + bh}, 1 spp, {filt}, "
                                 f"vs its plain version", band, n_band, want, n_want))
        before = pt.rebin_tex_launches
        rb, n_rb = pt.render_pt_rebin(c, scene, pos, quat, 1, **kw)
        same = torch.equal(rb, band) and int(n_rb) == int(n_band)
        log(f"  K5<tex> == K4<clusters, tex> on the band ({filt}) bit for bit: {same}; K5 tex "
            f"launches {pt.rebin_tex_launches - before}")
        if not same or pt.rebin_tex_launches - before != c.max_bounces + 1:
            raise AssertionError("K5 differs from K4 on the band")
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        want_rb, n_want_rb = pt.render_pt_rebin_reference(c, scene, pos, quat, 1, **kw)
        torch.cuda.synchronize(device)
        if filt == "trilinear":
            plain_rb_ms = (time.perf_counter() - t1) * 1e3
        k5_errs.append(hold_bitwise(f"K5<tex> rows {row0}..{row0 + bh}, 1 spp, {filt}, vs its "
                                    f"plain version", rb, n_rb, want_rb, n_want_rb))
    log(f"  plain versions on the trilinear band: megakernel {plain_ms / 1e3:.2f} s, rebin "
        f"{plain_rb_ms / 1e3:.2f} s")

    # (c)'s main path, counted from 0: whole frames through the entry points
    reset_launches()
    zs = [pos + torch.tensor([0.0, 0.0, 1e-4 * k], device=device) for k in range(SHOW_FRAMES + 1)]
    frame, n_frame = pt.render_pt_mega(cfg, scene, pos, quat, SHOW_SPP, seed=seed, bvh=cs)
    rays = []
    k4_ev, k4_host = cuda_ms(lambda k: rays.append(pt.render_pt_mega(
        cfg, scene, zs[k + 1], quat, SHOW_SPP, seed=seed, bvh=cs)[1]), SHOW_FRAMES)
    n_frame_rays = int(torch.stack(rays).sum()) // SHOW_FRAMES
    rb_frame, n_rb_frame = pt.render_pt_rebin(cfg, scene, pos, quat, SHOW_SPP, seed=seed, bvh=cs)
    fast, n_fast = render_pt_fast(cfg, scene, pos, quat, 1, seed=seed, bvh=cs)
    torch.cuda.synchronize(device)
    counts_c = {"K4 tex": pt.tex_launches["clusters"], "K5 tex": pt.rebin_tex_launches,
                "K6": cluster.launches}
    want_c = {"K4 tex": 1 + SHOW_FRAMES, "K5 tex": SHOW_SPP * (cfg.max_bounces + 1),
              "K6": 2 * (cfg.max_bounces + 1)}
    log(f"  launches on (c)'s main path {counts_c} (expected {want_c})")
    if counts_c != want_c or pt.launches != 1 + SHOW_FRAMES:
        raise AssertionError("(c)'s main path took other launches")
    same = torch.equal(rb_frame, frame) and int(n_rb_frame) == int(n_frame)
    log(f"  render_pt_rebin == render_pt_mega on the whole {SHOW_SPP}-spp trilinear frame bit "
        f"for bit: {same}")
    if not same:
        raise AssertionError("K5 differs from K4 on the frame")
    if not (torch.isfinite(fast).all() and fast.shape == frame.shape):
        raise AssertionError("render_pt_fast's frame is not finite")
    scale = n_frame_rays / band_rays
    ops = int((pt_ops(band_rays, int(scene.sph_count), 0)
               + instanced_ops(0, 0, band_work["slabs"], band_work["tests"])) * scale)
    feats = sum(4 * t.numel() for t in pt.feature_tables(pt.kernel_scene(scene, cs)).values()
                if t is not None)
    tables = k4_table_bytes(scene, cs, pos) + 4 * tb.tuv.numel() + feats
    bound = bound_ms(12 * cfg.width * cfg.height + tables, ops)
    k4_ms = device_ms(lambda k: pt.render_pt_mega(cfg, scene, zs[k % (SHOW_FRAMES + 1)], quat,
                                                  SHOW_SPP, seed=seed, bvh=cs),
                      SHOW_FRAMES, "pt_tex_kernel", setup=lambda k: k)
    log(f"  K4<clusters, tex> {cfg.width}x{cfg.height} {SHOW_SPP} spp, trilinear: {k4_ev:.4f} "
        f"ms/frame by CUDA events (host enqueue {k4_host:.4f} ms), {k4_ms:.4f} ms of device "
        f"time (the profiler's), {n_frame_rays} rays/frame; bound {bound[0]:.5f} ms by "
        f"{bound[1]} = {bound[0] / k4_ms:.2%} [{card}]")
    k5_dev = profiled_device_ms(lambda: pt.render_pt_rebin(cfg, scene, pos, quat, SHOW_SPP,
                                                           seed=seed, bvh=cs),
                                "pt_rebin_tex_kernel")
    if k5_dev is None:
        raise AssertionError("the profiler recorded no pt_rebin_tex_kernel in a frame")
    _, _, run = pt.rebin_bounce_launcher(cfg, scene, pos, quat, seed, cs)
    planes, n_px = state_plane_count(scene, cfg), cfg.width * cfg.height
    live = [live_rays(k5_states(run, cfg, s)) for s in range(SHOW_SPP)]
    k5_bound = bound_ms(sum(k5_bytes(n_px, lv, tables, planes) for lv in live), ops)
    log(f"  K5<tex> frame: {k5_dev:.4f} ms of device time over "
        f"{SHOW_SPP * (cfg.max_bounces + 1)} launches; bound {k5_bound[0]:.5f} ms by "
        f"{k5_bound[1]} (the {planes}-plane state of the live rays {live}) = "
        f"{k5_bound[0] / k5_dev:.2%} [{card}]")
    small = PTConfig(**SHOW_CPU, rng="pcg", tex_filter="trilinear")
    b_cpu = load_scene_json(str(out_dir / "textures.json"), device="cpu")
    cs_cpu = build_clusters(b_cpu.tris, tri_mats=b_cpu.tri_mats, vertex_normals=b_cpu.tri_normals,
                            vertex_uvs=b_cpu.tri_uvs, device="cpu")
    card_img, n_card = pt.render_pt_mega(small, scene, pos, quat, 2, seed=seed, bvh=cs)
    with correctly_rounded_sqrt():
        cpu_img, n_cpu = pt.render_pt_mega(small, b_cpu.scene, pos.cpu(), quat.cpu(), 2,
                                           seed=seed, bvh=cs_cpu)
    cpu_err = hold_pt(f"K4<clusters, tex> {small.width}x{small.height} 2 spp on the card vs the "
                      "plain version on the CPU (correctly rounded sqrt)", card_img.cpu(),
                      n_card, cpu_img, n_cpu)

    # (b) K7 on the UV base table: the frame's camera rays from config 5's camera
    iscene, ic, base = tex_instances(device)
    ipos, iquat = torch.zeros(3, device=device), torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    io, idr = _camera_rays(cfg, ipos, iquat, half, half)
    io, idr = tuple(x.contiguous() for x in io), tuple(x.contiguous() for x in idr)
    fi = pt.frame_view(ic, ipos)
    ikw = dict(attrs=True, tan=True, iorder=fi.iorder, iorders=fi.iorders)
    got = instanced.instanced_cluster_intersect(ic.inst_tab, base, io, idr, **ikw)
    instanced.work.update(gates=0, transforms=0)
    cluster.work.update(slabs=0, tests=0)
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    want = instanced.instanced_cluster_intersect_reference(ic.inst_tab, base, io, idr, **ikw)
    torch.cuda.synchronize(device)
    k7_plain_ms = (time.perf_counter() - t1) * 1e3
    k7_work = {**instanced.work, **cluster.work}
    hits = hold_planes(f"K7<uv, tan> on the frame's {n_rays} camera rays over "
                       f"{ic.num_instances} instances", got, want, 10)
    k7_ms = device_ms(lambda k: instanced.instanced_cluster_intersect(ic.inst_tab, base, io, idr,
                                                                      **ikw),
                      K7_REPS, "instanced_uv_kernel")
    tbb = cluster.sweep_tables(base)
    k7_tables = cluster_table_bytes([tbb.sbox, tbb.crec, tbb.trec, tbb.tsmooth, tbb.tuv,
                                     ic.inst_tab, fi.iorder, fi.iorders])
    k7_bound = bound_ms(k7_bytes(n_rays, True, k7_tables, uv=True, tan=True),
                        instanced_ops(k7_work["gates"], k7_work["transforms"], k7_work["slabs"],
                                      k7_work["tests"]))
    log(f"  K7<uv, tan> frame camera rays ({hits} hits): {k7_ms:.4f} ms of device time; plain "
        f"{k7_plain_ms:.1f} ms; bound {k7_bound[0]:.5f} ms by {k7_bound[1]} ({k7_work}) = "
        f"{k7_bound[0] / k7_ms:.2%} [{card}]")

    # (d) K4's texture instantiation with instances on a band, bit for bit
    irow0, ibh = TEX_INST_BAND
    ikw4 = dict(seed=seed, bvh=ic, row0=irow0, band_h=ibh)
    reset_k4()
    band, n_band = pt.render_pt_mega(cfg, iscene, ipos, iquat, 1, **ikw4)
    if pt.tex_launches["instances"] != 1:
        raise AssertionError(f"the band took another K4 instantiation: {pt.tex_launches}")
    instanced.work.update(gates=0, transforms=0)
    cluster.work.update(slabs=0, tests=0)
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    want, n_want = pt.render_pt_mega_reference(cfg, iscene, ipos, iquat, 1, **ikw4)
    torch.cuda.synchronize(device)
    iplain_ms = (time.perf_counter() - t1) * 1e3
    iband_work, iband_rays = {**instanced.work, **cluster.work}, int(n_want)
    errs.append(hold_bitwise(f"K4<instances, tex> rows {irow0}..{irow0 + ibh}, 1 spp, trilinear, "
                             f"vs its plain version (plain {iplain_ms / 1e3:.2f} s)", band, n_band,
                             want, n_want))

    # (d)'s main path, counted from 0
    reset_launches()
    izs = [ipos + torch.tensor([0.0, 0.0, 1e-4 * k], device=device)
           for k in range(SHOW_FRAMES + 1)]
    iframe, n_iframe = pt.render_pt_mega(cfg, iscene, ipos, iquat, SHOW_SPP, seed=seed, bvh=ic)
    rays = []
    ik4_ev, ik4_host = cuda_ms(lambda k: rays.append(pt.render_pt_mega(
        cfg, iscene, izs[k + 1], iquat, SHOW_SPP, seed=seed, bvh=ic)[1]), SHOW_FRAMES)
    n_iframe_rays = int(torch.stack(rays).sum()) // SHOW_FRAMES
    irb, n_irb = pt.render_pt_rebin(cfg, iscene, ipos, iquat, SHOW_SPP, seed=seed, bvh=ic)
    ifast, _ = render_pt_fast(cfg, iscene, ipos, iquat, 1, seed=seed, bvh=ic)
    torch.cuda.synchronize(device)
    counts_d = {"K4 tex": pt.tex_launches["instances"], "K5 tex": pt.rebin_tex_launches,
                "K7 uv": instanced.uv_launches, "K7": instanced.launches}
    want_d = {"K4 tex": 1 + SHOW_FRAMES, "K5 tex": SHOW_SPP * (cfg.max_bounces + 1),
              "K7 uv": cfg.max_bounces + 1, "K7": 2 * (cfg.max_bounces + 1)}
    log(f"  launches on (d)'s main path {counts_d} (expected {want_d})")
    if counts_d != want_d or pt.launches != 1 + SHOW_FRAMES:
        raise AssertionError("(d)'s main path took other launches")
    same = torch.equal(irb, iframe) and int(n_irb) == int(n_iframe)
    log(f"  render_pt_rebin == render_pt_mega with instances on the whole frame bit for bit: "
        f"{same}")
    if not same or not torch.isfinite(ifast).all():
        raise AssertionError("K5 differs from K4 with instances, or render_pt_fast is not finite")
    iscale = n_iframe_rays / iband_rays
    iops = int((pt_ops(iband_rays, int(iscene.sph_count), 0)
                + instanced_ops(iband_work["gates"], iband_work["transforms"],
                                iband_work["slabs"], iband_work["tests"])) * iscale)
    ifeats = sum(4 * t.numel() for t in pt.feature_tables(pt.kernel_scene(iscene, ic)).values()
                 if t is not None)
    itables = k4_table_bytes(iscene, ic, ipos) + 4 * tbb.tuv.numel() + ifeats
    ibound = bound_ms(12 * cfg.width * cfg.height + itables, iops)
    ik4_ms = device_ms(lambda k: pt.render_pt_mega(cfg, iscene, izs[k % (SHOW_FRAMES + 1)], iquat,
                                                   SHOW_SPP, seed=seed, bvh=ic),
                       SHOW_FRAMES, "pt_tex_kernel", setup=lambda k: k)
    log(f"  K4<instances, tex> {cfg.width}x{cfg.height} {SHOW_SPP} spp, trilinear: "
        f"{ik4_ev:.4f} ms/frame by CUDA events (host enqueue {ik4_host:.4f} ms), {ik4_ms:.4f} "
        f"ms of device time, {n_iframe_rays} rays/frame; bound {ibound[0]:.5f} ms by "
        f"{ibound[1]} = {ibound[0] / ik4_ms:.2%} [{card}]")
    ik5_dev = profiled_device_ms(lambda: pt.render_pt_rebin(cfg, iscene, ipos, iquat, SHOW_SPP,
                                                            seed=seed, bvh=ic),
                                 "pt_rebin_tex_kernel")
    log(f"  K5<tex> with instances: {ik5_dev} ms of device time over "
        f"{SHOW_SPP * (cfg.max_bounces + 1)} launches [{card}]")

    img = frame.cpu().numpy()
    means = img.reshape(-1, 3).mean(0)
    imeans = iframe.cpu().numpy().reshape(-1, 3).mean(0)
    if not (np.isfinite(img).all() and means.min() > 0.0 and imeans.min() > 0.0):
        raise AssertionError(f"a frame is non-finite or black: means {means} {imeans}")
    SMOKE_OUT.mkdir(exist_ok=True)
    write_png(str(TEX_PNG), tonemap(img, "aces", gamma=2.2))
    tmp.cleanup()
    log(f"  frames finite, channel means {[round(float(m), 5) for m in means]} and "
        f"{[round(float(m), 5) for m in imeans]}; {TEX_PNG.name} written; card vs CPU "
        f"{cpu_err:.6g}; phase {time.perf_counter() - t0:.1f} s")
    src = "raytracing_engine_tpu_torch/csrc/"
    k4 = "raytracing_engine_tpu/ops/pallas/pt_kernel.py:194"
    k5 = "raytracing_engine_tpu/ops/pallas/pt_kernel.py:699"
    return [
        {"name": "pt_tex_kernel<clusters> (K4: normal maps, mips, trilinear)", "route": "cuda",
         "source": src + "pt.cu", "replaces": k4, "launches": counts_c["K4 tex"],
         "max_abs_err": max(errs), "ms": k4_ms, "plain_ms": plain_ms, "bound_ms": bound[0],
         "bound_by": bound[1], "library_ms": None},
        {"name": "pt_tex_kernel<instances> (K4: a UV base table under instances)",
         "route": "cuda", "source": src + "pt.cu", "replaces": k4,
         "launches": counts_d["K4 tex"], "max_abs_err": errs[-1], "ms": ik4_ms,
         "plain_ms": iplain_ms, "bound_ms": ibound[0], "bound_by": ibound[1],
         "library_ms": None},
        {"name": "pt_rebin_tex_kernel (K5: normal maps, mips, trilinear)", "route": "cuda",
         "source": src + "pt.cu", "replaces": k5,
         "launches": counts_c["K5 tex"] + counts_d["K5 tex"], "max_abs_err": max(k5_errs),
         "ms": k5_dev, "plain_ms": plain_rb_ms, "bound_ms": k5_bound[0],
         "bound_by": k5_bound[1], "library_ms": None},
        {"name": "cluster_kernel<true, true> (K6: UV and tangent planes)", "route": "cuda",
         "source": src + "cluster.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/cluster_intersect.py:439",
         "launches": k6_launches, "max_abs_err": 0.0, "ms": k6_ms, "plain_ms": k6_plain_ms,
         "bound_ms": k6_bound[0], "bound_by": k6_bound[1], "library_ms": None},
        {"name": "instanced_uv_kernel<true> (K7: a UV base table)", "route": "cuda",
         "source": src + "instanced.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/instanced_intersect.py:225",
         "launches": counts_d["K7 uv"], "max_abs_err": 0.0, "ms": k7_ms,
         "plain_ms": k7_plain_ms, "bound_ms": k7_bound[0], "bound_by": k7_bound[1],
         "library_ms": None},
    ]


def adapt_state(grid, h: int, w: int, device):
    """A seeded adaptive state after SAMP_CELL_S - 1 passes and the next
    pass's radiance: half the cells active, each cell's M2 scaled so that
    the decisions differ from cell to cell; out zero (the plain check
    compares it bit for bit)."""
    from raytracing_engine_tpu_torch.ops.cuda import pt

    gen = torch.Generator(device=device).manual_seed(23)
    gh, gw = grid[:2]

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    st = pt.AdaptState.start(h, w, grid, SAMP_MIN, device)
    st.acc.copy_(rand(h, w, 3) * SAMP_CELL_S)
    st.mean.copy_(rand(h, w) + 0.05)
    st.m2.copy_(rand(h, w) * st.pixels(rand(gh * gw)) * (0.06 * SAMP_CELL_S))
    st.active.copy_((rand(gh * gw) < 0.5).to(torch.int32))
    st.taken.fill_(float(SAMP_CELL_S - 1))
    st.out.zero_()
    # the pass near each pixel's mean (the luminance weights sum to 1), so
    # that the cells' M2 scales decide
    return st, st.mean[..., None] + (rand(h, w, 3) - 0.5) * 0.1


def clone_state(st):
    from raytracing_engine_tpu_torch.ops.cuda import pt

    return pt.AdaptState(acc=st.acc.clone(), mean=st.mean.clone(), m2=st.m2.clone(),
                         active=st.active.clone(), taken=st.taken.clone(), out=st.out.clone(),
                         grid=st.grid)


def phase_sampling(device, card):
    """The sampling features (module docstring, phase 23); -> the kernels-line
    entries of K4 with R_d and adaptive spp, the cell update, and K4 and K5
    with the thin lens and R_d."""
    import dataclasses

    from raytracing_engine_tpu_torch.accel import build_clusters
    from raytracing_engine_tpu_torch.ops.cuda import cluster, pt
    from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
    from raytracing_engine_tpu_torch.pathtracer import PTConfig, load_scene_json, scenes
    from raytracing_engine_tpu_torch.pathtracer.wavefront import state_plane_count
    from raytracing_engine_tpu_torch.utils.timing import bound_ms, instanced_ops, k5_bytes, pt_ops

    t0 = time.perf_counter()
    seed = seed_from_int(1)
    quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    box, box_pos = scenes.cornell_box(device=device), torch.tensor(C4_POS, device=device)
    n_sph, n_tri = int(box.sph_count), int(box.tri_count)
    cfg = PTConfig(**SAMP, rng="pcg", sampler="r2")
    akw = dict(seed=seed, adaptive_tol=SAMP_TOL, adaptive_min=SAMP_MIN, return_spp=True)
    h, w = cfg.height, cfg.width
    grid = pt.adaptive_grid(box, h, w)

    # (a) the main path, counted from 0
    reset_launches()
    img, n_img, spp_map = pt.render_pt_mega(cfg, box, box_pos, quat, SAMP_SPP, **akw)
    torch.cuda.synchronize(device)
    counts_a = launch_counts()
    want_a = {"K4": SAMP_SPP, "K4 none": SAMP_SPP, "K4 sampling": SAMP_SPP,
              "K4 cells": SAMP_SPP}
    taken = spp_map.cpu()
    log(f"  (a) config 4's Cornell box {w}x{h}, R_d, adaptive tol {SAMP_TOL}, at least "
        f"{SAMP_MIN} of {SAMP_SPP} passes: {grid[0]} x {grid[1]} cells of {grid[2]}x{grid[3]}, "
        f"passes taken min {taken.min():.0f} mean {taken.mean():.4f} max {taken.max():.0f}, "
        f"{int(n_img)} rays; launches {counts_a} (expected {want_a})")
    if counts_a != want_a:
        raise AssertionError("(a)'s main path took other launches")
    if (tuple(taken.shape) != grid[:2] or spp_map.dtype != torch.float32
            or not ((taken >= SAMP_MIN) & (taken <= SAMP_SPP)).all()
            or not torch.isfinite(img).all()):
        raise AssertionError("the adaptive render's table or image is wrong")
    fixed, n_fixed = pt.render_pt_mega(cfg, box, box_pos, quat, SAMP_SPP, seed=seed)
    flat, n_flat, spp_flat = pt.render_pt_mega(cfg, box, box_pos, quat, SAMP_SPP,
                                               **dict(akw, adaptive_tol=0.0))
    ok0 = (torch.equal(flat, fixed) and int(n_flat) == int(n_fixed)
           and tuple(spp_flat.shape) == grid[:2] and bool((spp_flat == SAMP_SPP).all()))
    log(f"  adaptive_tol=0: bit for bit the fixed {SAMP_SPP}-pass render, its table all "
        f"{SAMP_SPP}: {ok0}; the adaptive render traced {int(n_img) / int(n_fixed):.4f} of its "
        f"rays")
    if not ok0:
        raise AssertionError("adaptive_tol=0 is not the fixed render")
    row0, bh = SAMP_BAND
    rows = slice(row0 // grid[2], (row0 + bh) // grid[2])
    band, n_band, spp_band = pt.render_pt_mega(cfg, box, box_pos, quat, SAMP_SPP, row0=row0,
                                               band_h=bh, **akw)
    same_rows = torch.equal(band, img[row0:row0 + bh]) and torch.equal(spp_band, spp_map[rows])
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    want, n_want, spp_want = pt.render_pt_mega_reference(
        cfg, box, box_pos, quat, SAMP_SPP, seed=seed, row0=row0, band_h=bh,
        adaptive_tol=SAMP_TOL, adaptive_min=SAMP_MIN)
    torch.cuda.synchronize(device)
    plain_a_ms = (time.perf_counter() - t1) * 1e3
    err_a = (band - want).abs().max().item()
    bit_a = (torch.equal(band, want) and int(n_band) == int(n_want)
             and torch.equal(spp_band, spp_want))
    log(f"  K4<none> adaptive on rows {row0}..{row0 + bh} (cells {spp_band.cpu().flatten().tolist()}"
        f" passes): the frame's rows and table {same_rows}; bit for bit its plain version (image, "
        f"table, rays {int(n_band)} == {int(n_want)}): {bit_a}, max_abs_err {err_a:.6g} (plain "
        f"{plain_a_ms / 1e3:.1f} s)")
    if not (same_rows and bit_a):
        raise AssertionError("K4's adaptive band differs from the frame or its plain version")

    # the cell update alone, bit for bit its plain version
    base, rad = adapt_state(grid, h, w, device)
    st_k, st_p = clone_state(base), clone_state(base)
    pt.adapt_pass(rad, st_k, SAMP_CELL_S, SAMP_MIN, SAMP_SPP, SAMP_TOL)
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    pt.adapt_pass_reference(rad, st_p, SAMP_CELL_S, SAMP_MIN, SAMP_SPP, SAMP_TOL)
    torch.cuda.synchronize(device)
    cell_plain_ms = (time.perf_counter() - t1) * 1e3
    fields = ("acc", "mean", "m2", "active", "taken", "out")
    same = {f: torch.equal(getattr(st_k, f), getattr(st_p, f)) for f in fields}
    cell_err = max((getattr(st_k, f).float() - getattr(st_p, f).float()).abs().max().item()
                   for f in fields)
    was = base.active.bool()
    stopped = int((was & (st_p.active == 0)).sum())
    log(f"  pt_cell_kernel on a seeded state at {w}x{h} ({int(was.sum())} of {was.numel()} "
        f"cells active, {stopped} of them stopping at {SAMP_CELL_S} passes): bit for bit its plain "
        f"version {same}")
    if not all(same.values()) or not 0 < stopped < int(was.sum()):
        raise AssertionError("the cell update differs from its plain version, or the seeded "
                             "state decides every cell alike")
    cell_ms = device_ms(lambda st: pt.adapt_pass(rad, st, SAMP_CELL_S, SAMP_MIN, SAMP_SPP,
                                                 SAMP_TOL),
                        5, "pt_cell_kernel", setup=lambda k: clone_state(base))
    act_px = int(base.pixels(was).sum())
    stop_px = int(base.pixels(was & (st_p.active == 0)).sum())
    cell_bound = bound_ms(52 * act_px + 12 * stop_px + 8 * was.numel(), 30 * act_px)
    log(f"  pt_cell_kernel {cell_ms:.4f} ms of device time; bound {cell_bound[0]:.5f} ms by "
        f"{cell_bound[1]} ({act_px} active pixels' rad, acc, mean and M2 read and acc, mean and "
        f"M2 written, {stop_px} pixels' image written) = {cell_bound[0] / cell_ms:.2%} [{card}]")

    # K4's time on the adaptive render (its launches summed) and on the fixed one
    k4a_ms = profiled_launches_ms(lambda: pt.render_pt_mega(cfg, box, box_pos, quat, SAMP_SPP,
                                                            **akw), "pt_samp_kernel", SAMP_SPP)
    k4f_ms = profiled_launches_ms(lambda: pt.render_pt_mega(cfg, box, box_pos, quat, SAMP_SPP,
                                                            seed=seed), "pt_samp_kernel", 1)
    cells_ms = profiled_launches_ms(lambda: pt.render_pt_mega(
        cfg, box, box_pos, quat, SAMP_SPP, **akw), "pt_cell_kernel", SAMP_SPP)
    px_passes = int((spp_map.double() * grid[2] * grid[3]).sum())
    k4a_bound = bound_ms(12 * px_passes + k4_table_bytes(box, None, box_pos),
                         pt_ops(int(n_img), n_sph, n_tri))
    log(f"  K4 pt_samp_kernel<none> R_d adaptive {w}x{h}: {k4a_ms:.4f} ms of device time over {SAMP_SPP} "
        f"launches ({cells_ms:.4f} ms of cell updates beside); fixed {SAMP_SPP} passes "
        f"{k4f_ms:.4f} ms; bound of the passes taken {k4a_bound[0]:.5f} ms by {k4a_bound[1]} "
        f"({int(n_img)} rays x {n_sph} spheres and {n_tri} triangles, {px_passes} pixel-passes "
        f"written) = {k4a_bound[0] / k4a_ms:.2%} [{card}]")

    # (b) the showcase through the thin lens with R_d
    b = load_scene_json(str(SHOWCASE))
    scene = b.scene
    cs = build_clusters(b.tris, tri_mats=b.tri_mats, vertex_normals=b.tri_normals)
    pos, squat = torch.from_numpy(b.cam_pos).to(device), torch.from_numpy(b.cam_quat).to(device)
    scfg = PTConfig(**SHOW, rng="pcg", sampler="r2", **SAMP_LENS)
    reset_launches()
    frame, n_frame = pt.render_pt_mega(scfg, scene, pos, squat, SHOW_SPP, seed=seed, bvh=cs)
    rb, n_rb = pt.render_pt_rebin(scfg, scene, pos, squat, SHOW_SPP, seed=seed, bvh=cs)
    torch.cuda.synchronize(device)
    counts_b = launch_counts()
    nb = SHOW_SPP * (scfg.max_bounces + 1)
    want_b = {"K4": 1, "K4 material": 1, "K4 sampling": 1, "K5": nb, "K5 material": nb,
              "K5 sampling": nb}
    same_b = torch.equal(rb, frame) and int(n_rb) == int(n_frame)
    log(f"  (b) the showcase {scfg.width}x{scfg.height}, thin lens {SAMP_LENS}, R_d, "
        f"{SHOW_SPP} spp: K5's frame bit for bit K4's {same_b} ({int(n_frame)} rays); launches "
        f"{counts_b} (expected {want_b})")
    if counts_b != want_b or not same_b or not torch.isfinite(frame).all():
        raise AssertionError("(b)'s main path took other launches, or K5 differs from K4")
    row0, bh = SHOW_BAND
    kw = dict(seed=seed, bvh=cs, row0=row0, band_h=bh)
    k4b, n_k4b = pt.render_pt_mega(scfg, scene, pos, squat, SAMP_SHOW_SPP, **kw)
    k5b, n_k5b = pt.render_pt_rebin(scfg, scene, pos, squat, SAMP_SHOW_SPP, **kw)
    cluster.work.update(slabs=0, tests=0)
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    want4, n_want4 = pt.render_pt_mega_reference(scfg, scene, pos, squat, SAMP_SHOW_SPP, **kw)
    torch.cuda.synchronize(device)
    plain4_ms = (time.perf_counter() - t1) * 1e3
    band_work = dict(cluster.work)
    t1 = time.perf_counter()
    want5, n_want5 = pt.render_pt_rebin_reference(scfg, scene, pos, squat, SAMP_SHOW_SPP, **kw)
    torch.cuda.synchronize(device)
    plain5_ms = (time.perf_counter() - t1) * 1e3
    err4, err5 = (k4b - want4).abs().max().item(), (k5b - want5).abs().max().item()
    bit4 = torch.equal(k4b, want4) and int(n_k4b) == int(n_want4)
    bit5 = torch.equal(k5b, want5) and int(n_k5b) == int(n_want5)
    log(f"  rows {row0}..{row0 + bh}, {SAMP_SHOW_SPP} spp: K4<clusters, material> bit for bit its "
        f"plain version {bit4} (max_abs_err {err4:.6g}, plain {plain4_ms / 1e3:.1f} s), "
        f"K5<material> {bit5} (max_abs_err {err5:.6g}, plain {plain5_ms / 1e3:.1f} s)")
    if not (bit4 and bit5):
        raise AssertionError("K4 or K5 with the thin lens and R_d differs from its plain version")
    scale = int(n_frame) / int(n_want4)
    ops = int((pt_ops(int(n_want4), int(scene.sph_count), 0)
               + instanced_ops(0, 0, band_work["slabs"], band_work["tests"])) * scale)
    tables = k4_table_bytes(scene, cs, pos)
    k4b_bound = bound_ms(12 * scfg.width * scfg.height + tables, ops)
    zs = [pos + torch.tensor([0.0, 0.0, 1e-4 * k], device=device) for k in range(SHOW_FRAMES + 1)]
    k4b_ms = device_ms(lambda k: pt.render_pt_mega(scfg, scene, zs[k % (SHOW_FRAMES + 1)], squat,
                                                   SHOW_SPP, seed=seed, bvh=cs),
                       SHOW_FRAMES, "pt_samp_kernel", setup=lambda k: k)
    _, _, run = pt.rebin_bounce_launcher(scfg, scene, pos, squat, seed, cs)
    states = [k5_states(run, scfg, g) for g in range(SHOW_SPP)]
    k5b_ms = profiled_launches_ms(lambda: pt.render_pt_rebin(scfg, scene, pos, squat, SHOW_SPP,
                                                             seed=seed, bvh=cs),
                                  "pt_rebin_samp_kernel", nb,
                                  fallback=lambda: k5_events_ms(run, states))
    planes, n_px = state_plane_count(scene), scfg.width * scfg.height
    live = [live_rays(x) for x in states]
    k5b_bound = bound_ms(sum(k5_bytes(n_px, lv, tables, planes) for lv in live), ops)
    log(f"  K4 pt_samp_kernel<clusters, material> thin lens + R_d {k4b_ms:.4f} ms of device "
        f"time a frame, "
        f"bound {k4b_bound[0]:.5f} ms by {k4b_bound[1]} = {k4b_bound[0] / k4b_ms:.2%}; "
        f"K5<material> {k5b_ms:.4f} ms over {nb} launches, bound {k5b_bound[0]:.5f} ms by "
        f"{k5b_bound[1]} = {k5b_bound[0] / k5b_ms:.2%} [{card}]")

    # (c) run_all.py's quality row at 256x256
    qcfg = PTConfig(**C4, rng="pcg")
    r2cfg = dataclasses.replace(qcfg, sampler="r2")
    ref, _ = pt.render_pt_mega(qcfg, box, box_pos, quat, QUALITY_REF_SPP, seed=seed_from_int(99),
                               tile=QUALITY_TILE)

    def timed(fn):
        fn(0)  # warm-up
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        out = fn(1)
        torch.cuda.synchronize(device)
        return out, time.perf_counter() - t

    (img_f, _), t_fixed = timed(lambda off: pt.render_pt_mega(
        qcfg, box, box_pos, quat, QUALITY_SPP, seed=seed, spp_offset=off, tile=QUALITY_TILE))
    (img_q, _, sm), t_q = timed(lambda off: pt.render_pt_mega(
        r2cfg, box, box_pos, quat, QUALITY_SPP, seed=seed, spp_offset=off, tile=QUALITY_TILE,
        adaptive_tol=SAMP_TOL, return_spp=True))
    mse_f = ((img_f - ref) ** 2).mean().item()
    mse_q = ((img_q - ref) ** 2).mean().item()
    log(f"  (c) run_all.py's quality row, config 4 {qcfg.width}x{qcfg.height}, tile "
        f"{QUALITY_TILE}, against a {QUALITY_REF_SPP}-spp render of PRNGKey(99): fixed random "
        f"{QUALITY_SPP} spp {t_fixed:.6f} s, MSE {mse_f:.9g}; R_d + adaptive tol {SAMP_TOL} in "
        f"the same budget {t_q:.6f} s, MSE {mse_q:.9g}, mean spp {sm.mean().item():.4f} [{card}]")
    if not (math.isfinite(mse_f) and math.isfinite(mse_q)):
        raise AssertionError("the quality row's renders are not finite")
    log(f"  phase 23: {time.perf_counter() - t0:.1f} s")
    src = "raytracing_engine_tpu_torch/csrc/pt.cu"
    k4 = "raytracing_engine_tpu/ops/pallas/pt_kernel.py:194"
    k5 = "raytracing_engine_tpu/ops/pallas/pt_kernel.py:699"
    return [
        {"name": "pt_samp_kernel<none> (K4: R_d, adaptive spp)", "route": "cuda", "source": src,
         "replaces": k4, "launches": counts_a["K4 sampling"], "max_abs_err": err_a,
         "ms": k4a_ms, "plain_ms": plain_a_ms, "bound_ms": k4a_bound[0],
         "bound_by": k4a_bound[1], "library_ms": None},
        {"name": "pt_cell_kernel (K4 adaptive spp: the cells' update)", "route": "cuda",
         "source": src, "replaces": k4, "launches": counts_a["K4 cells"],
         "max_abs_err": cell_err, "ms": cell_ms, "plain_ms": cell_plain_ms,
         "bound_ms": cell_bound[0], "bound_by": cell_bound[1], "library_ms": None},
        {"name": "pt_samp_kernel<clusters, material> (K4: thin lens, R_d)", "route": "cuda",
         "source": src, "replaces": k4, "launches": counts_b["K4 sampling"],
         "max_abs_err": err4, "ms": k4b_ms, "plain_ms": plain4_ms, "bound_ms": k4b_bound[0],
         "bound_by": k4b_bound[1], "library_ms": None},
        {"name": "pt_rebin_samp_kernel<material> (K5: thin lens, R_d)", "route": "cuda",
         "source": src, "replaces": k5, "launches": counts_b["K5 sampling"],
         "max_abs_err": err5, "ms": k5b_ms, "plain_ms": plain5_ms, "bound_ms": k5b_bound[0],
         "bound_by": k5b_bound[1], "library_ms": None},
    ]


def grid_light_scene(device, light_tree=0, n=TREE_N):
    """tests/test_light_tree.py:29-47: a big diffuse floor under an n x n grid
    of equal emissive spheres spread far apart."""
    from raytracing_engine_tpu_torch.pathtracer import build_pt_scene

    mats = [{"albedo": (0.6, 0.6, 0.6)}] + [
        {"albedo": (0, 0, 0), "emission": (40.0, 32.0, 24.0)} for _ in range(n * n)]
    spheres = [((0.0, 30.0, -1001.0), 1000.0, 0)]
    for i in range(n):
        for j in range(n):
            spheres.append(((i * 16.0 - 24.0, 14.0 + j * 16.0, 2.0), 0.4, 1 + i * n + j))
    return build_pt_scene(spheres=spheres, materials=mats, light_tree=light_tree, device=device)


def mesh_light_scene(device, mode):
    """tests/test_mesh_lights.py:26-46: an emissive icosphere (MESH_LAMP)
    above a two-triangle floor and a diffuse ball, mesh_lights=mode; ->
    (scene, its ClusterSet)."""
    from raytracing_engine_tpu_torch.accel import build_clusters, icosphere
    from raytracing_engine_tpu_torch.pathtracer import build_pt_scene

    lamp = icosphere(**MESH_LAMP)
    floor = np.array([[[-8, -2, -1.5], [8, -2, -1.5], [8, 14, -1.5]],
                      [[-8, -2, -1.5], [8, 14, -1.5], [-8, 14, -1.5]]], np.float32)
    tris = np.concatenate([floor, lamp], axis=0)
    mats = np.array([0] * 2 + [1] * len(lamp), np.int32)
    scene = build_pt_scene(
        spheres=[((1.2, 6.0, -0.6), 0.9, 2)], triangles=tris, tri_mats=mats,
        materials=[{"albedo": (0.65, 0.6, 0.55)}, {"albedo": (0, 0, 0), "emission": (6.0,) * 3},
                   {"albedo": (0.4, 0.45, 0.7)}], mesh_lights=mode, device=device)
    return scene, build_clusters(tris, tri_mats=mats, device=device)


def phase_lights(device, card):
    """The light features (module docstring, phase 24); -> the kernels-line
    entries of K4 and K5 with them."""
    from raytracing_engine_tpu_torch.ops.cuda import cluster, pt
    from raytracing_engine_tpu_torch.ops.rng_pcg import prng_key_data, seed_from_int
    from raytracing_engine_tpu_torch.pathtracer import PTConfig, load_scene_json, scenes
    from raytracing_engine_tpu_torch.pathtracer.wavefront import render_pt_fast, state_plane_count
    from raytracing_engine_tpu_torch.utils.image import to_srgb_u8
    from raytracing_engine_tpu_torch.utils.timing import bound_ms, instanced_ops, k5_bytes, pt_ops

    t0 = time.perf_counter()
    seed = seed_from_int(1)
    quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    row0, bh = LIGHTS_BAND
    src = "raytracing_engine_tpu_torch/csrc/pt_lights.cu"
    k4_src = "raytracing_engine_tpu/ops/pallas/pt_kernel.py:194"
    k5_src = "raytracing_engine_tpu/ops/pallas/pt_kernel.py:699"
    entries = []

    def poses(pos):
        return [pos + torch.tensor([0.0, 0.0, 1e-4 * k], device=device)
                for k in range(LIGHTS_FRAMES + 1)]

    def main_path(label, fn, want):
        """fn() under the launch counters from 0; -> (its output, the counts)."""
        reset_launches()
        res = fn()
        torch.cuda.synchronize(device)
        counts = launch_counts()
        log(f"  {label}: launches {counts} (expected {want})")
        if counts != want or not all(torch.isfinite(r).all() for r in res[::2]):
            raise AssertionError(f"{label}: other launches, or a non-finite image")
        return res, counts

    def band(label, cfg, scene, bvh, pos, rebin=False):
        """K4 (and K5) on the band at 1 spp, image and rays bit for bit their
        plain versions; -> errors, the plain versions' ms, the plain K4's
        rays and cluster work."""
        kw = dict(seed=seed, bvh=bvh, row0=row0, band_h=bh)
        k4b, n4 = pt.render_pt_mega(cfg, scene, pos, quat, 1, **kw)
        cluster.work.update(slabs=0, tests=0)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        w4, m4 = pt.render_pt_mega_reference(cfg, scene, pos, quat, 1, **kw)
        torch.cuda.synchronize(device)
        res = dict(plain4_ms=(time.perf_counter() - t1) * 1e3, work=dict(cluster.work),
                   rays=int(m4), err4=(k4b - w4).abs().max().item())
        ok = [torch.equal(k4b, w4) and int(n4) == int(m4)]
        msg = (f"K4 {ok[0]} (max_abs_err {res['err4']:.6g}, rays {int(n4)} == {int(m4)}, plain "
               f"{res['plain4_ms'] / 1e3:.2f} s)")
        if rebin:
            k5b, n5 = pt.render_pt_rebin(cfg, scene, pos, quat, 1, **kw)
            torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            w5, m5 = pt.render_pt_rebin_reference(cfg, scene, pos, quat, 1, **kw)
            torch.cuda.synchronize(device)
            res["plain5_ms"] = (time.perf_counter() - t1) * 1e3
            res["err5"] = (k5b - w5).abs().max().item()
            ok.append(torch.equal(k5b, w5) and int(n5) == int(m5))
            msg += (f", K5 {ok[1]} (max_abs_err {res['err5']:.6g}, rays {int(n5)} == {int(m5)}"
                    f", plain {res['plain5_ms'] / 1e3:.2f} s)")
        log(f"  {label}: rows {row0}..{row0 + bh - 1} at 1 spp bit for bit the plain versions: "
            f"{msg}")
        if not all(ok):
            raise AssertionError(f"{label}: a kernel differs from its plain version")
        return res

    def k4_entry(name, counts, res, ms, bound):
        return {"name": name, "route": "cuda", "source": src, "replaces": k4_src,
                "launches": counts["K4 lights"], "max_abs_err": res["err4"], "ms": ms,
                "plain_ms": res["plain4_ms"], "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None}

    # (a) fog and single-scatter media on the Cornell box
    box, box_pos = scenes.cornell_box(device=device), torch.tensor(C4_POS, device=device)
    n_sph, n_tri = int(box.sph_count), int(box.tri_count)
    fcfg = PTConfig(**LIGHTS, rng="pcg", **LIGHTS_FOG)
    ccfg = PTConfig(**LIGHTS, rng="pcg")
    (img, n_img), counts_a = main_path(
        f"(a) the Cornell box {fcfg.width}x{fcfg.height}, {LIGHTS_FOG}, {LIGHTS_SPP} spp",
        lambda: pt.render_pt_mega(fcfg, box, box_pos, quat, LIGHTS_SPP, seed=seed),
        {"K4": 1, "K4 none": 1, "K4 lights": 1})
    clear, n_clear = pt.render_pt_mega(ccfg, box, box_pos, quat, LIGHTS_SPP, seed=seed)
    log(f"  fog: mean radiance {img.mean().item():.6f} (clear {clear.mean().item():.6f}), rays "
        f"{int(n_img)} ({int(n_img) / int(n_clear):.4f} of the clear render's)")
    ra = band("K4<none> fog + media", fcfg, box, None, box_pos)
    fz = poses(box_pos)
    fog_ms = device_ms(lambda k: pt.render_pt_mega(fcfg, box, fz[k], quat, LIGHTS_SPP,
                                                   seed=seed), LIGHTS_FRAMES, "pt_lights_kernel",
                       setup=lambda k: k)
    clear_ms = device_ms(lambda k: pt.render_pt_mega(ccfg, box, fz[k], quat, LIGHTS_SPP,
                                                     seed=seed), LIGHTS_FRAMES, "pt_kernel",
                         setup=lambda k: k)
    fog_bound = bound_ms(12 * fcfg.width * fcfg.height + k4_table_bytes(box, None, box_pos),
                         pt_ops(int(n_img), n_sph, n_tri))
    log(f"  K4 pt_lights_kernel<none> fog + media {fog_ms:.4f} ms of device time a frame (the "
        f"clear frame's pt_kernel<none> {clear_ms:.4f} ms); bound {fog_bound[0]:.5f} ms by "
        f"{fog_bound[1]} ({int(n_img)} rays, media shadow rays among them, x {n_sph} spheres and "
        f"{n_tri} triangles) = {fog_bound[0] / fog_ms:.2%} [{card}]")
    entries.append(k4_entry("pt_lights_kernel<none> (K4: fog, single-scatter media)", counts_a,
                            ra, fog_ms, fog_bound))

    # (b) the light tree on a grid of 64 sphere lights, beside power selection
    grid = grid_light_scene(device, light_tree=TREE_C)
    tpos = torch.tensor(TREE_POS, device=device)
    tcfg = PTConfig(**TREE, rng="pcg", light_sampling="tree")
    pcfg = PTConfig(**TREE, rng="pcg")
    (timg, n_timg), counts_b = main_path(
        f"(b) {TREE_N} x {TREE_N} sphere lights, a {TREE_C}-cluster tree, "
        f"{tcfg.width}x{tcfg.height}, {tcfg.max_bounces} bounces, {LIGHTS_SPP} spp",
        lambda: pt.render_pt_mega(tcfg, grid, tpos, quat, LIGHTS_SPP, seed=seed),
        {"K4": 1, "K4 none": 1, "K4 lights": 1})
    pimg, n_pimg = pt.render_pt_mega(pcfg, grid, tpos, quat, LIGHTS_SPP, seed=seed)
    # the camera rays and their direct light hits are the same in both: the
    # means differ by the floor's NEE estimators alone (heavy-tailed under
    # power selection, tests/test_light_tree.py:159-162)
    tm, pm = timg.double().mean().item(), pimg.double().mean().item()
    log(f"  tree vs power selection ({int(n_timg)} and {int(n_pimg)} rays): the image's mean "
        f"{tm:.6f} and {pm:.6f} (relative difference {abs(tm - pm) / max(pm, 1e-12):.4f})")
    rb = band("K4<none> light tree", tcfg, grid, None, tpos)
    tz = poses(tpos)
    tree_ms = device_ms(lambda k: pt.render_pt_mega(tcfg, grid, tz[k], quat, LIGHTS_SPP,
                                                    seed=seed), LIGHTS_FRAMES, "pt_lights_kernel",
                        setup=lambda k: k)
    power_ms = device_ms(lambda k: pt.render_pt_mega(pcfg, grid, tz[k], quat, LIGHTS_SPP,
                                                     seed=seed), LIGHTS_FRAMES, "pt_kernel",
                         setup=lambda k: k)
    g_sph = int(grid.sph_count)
    tree_bound = bound_ms(12 * tcfg.width * tcfg.height + k4_table_bytes(grid, None, tpos)
                          + 4 * grid.lt_center.shape[0] * 8, pt_ops(int(n_timg), g_sph, 0))
    log(f"  K4 pt_lights_kernel<none> light tree {tree_ms:.4f} ms of device time a frame, power "
        f"selection (pt_kernel<none>) {power_ms:.4f} ms: x {tree_ms / power_ms:.3f}; bound "
        f"{tree_bound[0]:.5f} ms by {tree_bound[1]} ({int(n_timg)} rays x {g_sph} spheres) = "
        f"{tree_bound[0] / tree_ms:.2%} [{card}]")
    entries.append(k4_entry("pt_lights_kernel<none> (K4: the light tree)", counts_b, rb,
                            tree_ms, tree_bound))

    # (c) mesh lights per pass and per lane over a ClusterSet, K4 and K5
    mpos = torch.tensor(MESH_POS, device=device)
    mcfg = PTConfig(**LIGHTS, rng="pcg")
    nb = LIGHTS_SPP * (mcfg.max_bounces + 1)
    for mode, what in ((True, "per pass"), ("lane", "per lane")):
        scene, cs = mesh_light_scene(device, mode)

        def both():
            k4, n4 = pt.render_pt_mega(mcfg, scene, mpos, quat, LIGHTS_SPP, seed=seed, bvh=cs)
            k5, n5 = pt.render_pt_rebin(mcfg, scene, mpos, quat, LIGHTS_SPP, seed=seed, bvh=cs)
            return k4, n4, k5, n5

        (k4, n4, k5, n5), counts_c = main_path(
            f"(c) mesh lights {what}: a ClusterSet of {int(scene.tri_count)} triangles, "
            f"{int(scene.tri_count) - 2} of them in the light table's mesh slot, "
            f"{mcfg.width}x{mcfg.height}, {LIGHTS_SPP} spp, K4 and K5",
            both, {"K4": 1, "K4 lights": 1, "K5": nb, "K5 lights": nb})
        same = torch.equal(k5, k4) and int(n5) == int(n4)
        log(f"  K5's frame bit for bit K4's: {same} ({int(n4)} rays)")
        if not same:
            raise AssertionError(f"mesh lights {what}: K5 differs from K4")
        rc = band(f"K4<clusters> and K5, mesh lights {what}", mcfg, scene, cs, mpos, rebin=True)
        scale = int(n4) / rc["rays"]
        ops = int((pt_ops(rc["rays"], int(scene.sph_count), 0)
                   + instanced_ops(0, 0, rc["work"]["slabs"], rc["work"]["tests"])) * scale)
        lt = pt.light_tables(pt.kernel_scene(scene, cs))
        tables = k4_table_bytes(scene, cs, mpos) + sum(
            4 * t.numel() for t in lt.values() if t is not None) + 64 * LIGHTS_SPP
        k4_bound = bound_ms(12 * mcfg.width * mcfg.height + tables, ops)
        mz = poses(mpos)
        k4_ms = device_ms(lambda k: pt.render_pt_mega(mcfg, scene, mz[k], quat, LIGHTS_SPP,
                                                      seed=seed, bvh=cs), LIGHTS_FRAMES,
                          "pt_lights_kernel", setup=lambda k: k)
        _, _, run = pt.rebin_bounce_launcher(mcfg, scene, mpos, quat, seed, cs)
        states = [k5_states(run, mcfg, g) for g in range(LIGHTS_SPP)]
        k5_ms = profiled_launches_ms(lambda: pt.render_pt_rebin(mcfg, scene, mpos, quat,
                                                                LIGHTS_SPP, seed=seed, bvh=cs),
                                     "pt_rebin_lights_kernel", nb,
                                     fallback=lambda: k5_events_ms(run, states))
        planes, n_px = state_plane_count(scene, mcfg), mcfg.width * mcfg.height
        live = [live_rays(x) for x in states]
        k5_bound = bound_ms(sum(k5_bytes(n_px, lv, tables, planes) for lv in live), ops)
        log(f"  mesh lights {what}: K4 pt_lights_kernel<clusters> {k4_ms:.4f} ms of device time a "
            f"frame, bound {k4_bound[0]:.5f} ms by {k4_bound[1]} = {k4_bound[0] / k4_ms:.2%}; K5 "
            f"pt_rebin_lights_kernel {k5_ms:.4f} ms over {nb} launches, bound {k5_bound[0]:.5f} ms "
            f"by {k5_bound[1]} = {k5_bound[0] / k5_ms:.2%} ({ops} ops: the band's "
            f"{rc['work']['slabs']} box + {rc['work']['tests']} triangle tests and {rc['rays']} "
            f"rays x {int(scene.sph_count)} spheres, x {scale:.6g}) [{card}]")
        entries.append(k4_entry(f"pt_lights_kernel<clusters> (K4: mesh lights {what})", counts_c,
                                rc, k4_ms, k4_bound))
        entries.append({"name": f"pt_rebin_lights_kernel (K5: mesh lights {what})",
                        "route": "cuda", "source": src, "replaces": k5_src,
                        "launches": counts_c["K5 lights"], "max_abs_err": rc["err5"],
                        "ms": k5_ms, "plain_ms": rc["plain5_ms"], "bound_ms": k5_bound[0],
                        "bound_by": k5_bound[1], "library_ms": None})

    # (d) the command line: pt --fog, through the megakernel and the wavefront,
    # and a scene file with mesh lights (auto: a ClusterSet and K5)
    out = CLI_OUT
    out.mkdir(parents=True, exist_ok=True)
    key = prng_key_data(0)
    fog_args = ["--fog", 0.05, "--fog-color", 0.1, 0.1, 0.12]
    w, h, spp = CLI_LIGHTS
    size = f"{w}x{h}"
    small = dict(width=w, height=h, max_bounces=4, rng="pcg", fog_density=0.05,
                 fog_color=(0.1, 0.1, 0.12))
    counts = run_cli(["pt", "--scene", "cornell", "--mega", "--size", size, "--spp", spp,
                      *fog_args, "--out", out / "cornell_fog_mega.png"])
    (img, _), ms = kernel_device_ms(lambda: pt.render_pt_mega(
        PTConfig(**small), box, box_pos, quat, spp, key))
    check_cli("pt cornell --mega --fog", counts, {"K4": 1, "K4 none": 1, "K4 lights": 1},
              {"cornell_fog_mega.png": (png_of(out / "cornell_fog_mega.png"),
                                        to_srgb_u8(img.cpu().numpy()))}, ms, 1, card)
    counts = run_cli(["pt", "--scene", "cornell", "--size", f"{w // 2}x{h // 2}", "--spp", 2,
                      *fog_args, "--out", out / "cornell_fog.png"])
    img, _ = render_pt_fast(PTConfig(**dict(small, width=w // 2, height=h // 2)), box, box_pos,
                            quat, 2, key)
    check_cli("pt cornell --fog (the wavefront)", counts, {},
              {"cornell_fog.png": (png_of(out / "cornell_fog.png"),
                                   to_srgb_u8(img.cpu().numpy()))}, {}, 1, card)
    spec = {"materials": [{"albedo": [0.6, 0.6, 0.6]},
                          {"albedo": [0, 0, 0], "emission": [6, 6, 6]}],
            "spheres": [{"center": [0, 6, -51.5], "radius": 50, "mat": 0}],
            "meshes": [{"icosphere": {k: list(v) if isinstance(v, tuple) else v
                                      for k, v in MESH_LAMP.items()}, "mat": 1}],
            "camera": {"position": list(MESH_POS), "quat": [0, 0, 0, 1]},
            "mesh_lights": True}
    path = out / "mesh_lights.json"
    path.write_text(json.dumps(spec))
    counts = run_cli(["pt", "--scene", path, "--bvh", "--size", size, "--spp", LIGHTS_SPP,
                      "--out", out / "mesh_lights.png"])
    b = load_scene_json(str(path), device=device)
    from raytracing_engine_tpu_torch.accel import build_clusters

    cs = build_clusters(b.tris, tri_mats=b.tri_mats, vertex_normals=b.tri_normals,
                        vertex_uvs=b.tri_uvs, device=device)
    fcfg5 = PTConfig(width=w, height=h, max_bounces=4, rng="pcg")
    (img, _), ms = kernel_device_ms(lambda: pt.render_pt_rebin(
        fcfg5, b.scene, torch.from_numpy(b.cam_pos).to(device),
        torch.from_numpy(b.cam_quat).to(device), LIGHTS_SPP, key, bvh=cs))
    n5 = LIGHTS_SPP * 5
    check_cli("pt mesh_lights.json --bvh (rebin)", counts, {"K5": n5, "K5 lights": n5},
              {"mesh_lights.png": (png_of(out / "mesh_lights.png"),
                                   to_srgb_u8(img.cpu().numpy()))}, ms, 1, card)
    log(f"  phase 24: {time.perf_counter() - t0:.1f} s")
    return entries


def reset_launches():
    """Every kernel's launch count to 0 (K4's by kind and material too)."""
    from raytracing_engine_tpu_torch.ops.cuda import (
        bvh_traverse,
        cluster,
        depth,
        fused,
        instanced,
        pt,
        rng,
        shade,
    )

    reset_k4()
    for mod in (bvh_traverse, cluster, depth, fused, instanced, rng, shade):
        mod.launches = 0
    pt.rebin_launches = pt.rebin_material_launches = pt.rebin_tex_launches = 0
    pt.sampling_launches = pt.rebin_sampling_launches = 0
    pt.adapt_launches = 0
    pt.light_launches = pt.rebin_light_launches = 0
    cluster.tan_launches = instanced.uv_launches = 0


def launch_counts() -> dict:
    """The launch counts that are not 0: K1..K9, and K4 without a mesh and
    the material and texture instantiations of K4 to K7 apart."""
    from raytracing_engine_tpu_torch.ops.cuda import (
        bvh_traverse,
        cluster,
        depth,
        fused,
        instanced,
        pt,
        rng,
        shade,
    )

    counts = {"K1": depth.launches, "K2": fused.launches, "K3": shade.launches,
              "K4": pt.launches, "K4 none": pt.mesh_launches["none"],
              "K4 material": sum(pt.material_launches.values()),
              "K4 tex": sum(pt.tex_launches.values()), "K4 sampling": pt.sampling_launches,
              "K4 cells": pt.adapt_launches, "K4 lights": pt.light_launches,
              "K5": pt.rebin_launches, "K5 lights": pt.rebin_light_launches,
              "K5 material": pt.rebin_material_launches,
              "K5 tex": pt.rebin_tex_launches, "K5 sampling": pt.rebin_sampling_launches,
              "K6": cluster.launches, "K6 tan": cluster.tan_launches,
              "K7 uv": instanced.uv_launches,
              "K7": instanced.launches, "K8": bvh_traverse.launches, "K9": rng.launches}
    return {k: n for k, n in counts.items() if n}


def kernel_device_ms(fn):
    """(fn(), {kernel: device ms}) with fn run under torch.profiler: the
    port's kernels (PORT_KERNELS) by name; {} where the profiler records none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for k, name in PORT_KERNELS.items():
            if name in e.name:
                ms[k] = ms.get(k, 0.0) + e.time_range.elapsed_us() / 1e3
    return out, ms


def post_step(url: str, event: dict):
    """POST one event to a live server: (status, body, headers, round-trip ms)."""
    import urllib.request

    req = urllib.request.Request(url + "/step", data=json.dumps(event).encode(), method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        status, body, hdrs = r.status, r.read(), dict(r.headers)
    return status, body, hdrs, (time.perf_counter() - t0) * 1e3


def png_of(data) -> np.ndarray:
    """The pixels of an RGB8 PNG (its bytes, or a path). utils.image.encode_png
    writes filter type 0 on every row, so those decode with one inflate;
    any other PNG goes through utils.image.read_png (a Python loop a pixel,
    about 5 s for a 1920x1088 frame)."""
    import struct
    import zlib

    from raytracing_engine_tpu_torch.utils.image import read_png

    if not isinstance(data, bytes):
        data = Path(data).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, idat, head = 8, [], None
    while pos < len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IHDR":
            head = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        elif tag == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
    w, h, bit, ctype = head
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 3 * w + 1)
    if bit == 8 and ctype == 2 and not rows[:, 0].any():
        return rows[:, 1:].reshape(h, w, 3)
    path = CLI_OUT / "filtered.png"
    path.write_bytes(data)
    return read_png(str(path))


def phase_live(cfg, scene, card) -> dict:
    """(a) of phase 21: the live server over loopback, each stage of a /step
    timed by wrapping the server's own functions (the quantizer waits for
    its kernel so that the copy is timed alone). -> launch counts."""
    from raytracing_engine_tpu_torch.models import cuda_renderer
    from raytracing_engine_tpu_torch.runtime import FrameLoop, InputEvent, LiveFrameServer, live
    from raytracing_engine_tpu_torch.utils.image import to_srgb_u8

    CLI_OUT.mkdir(parents=True, exist_ok=True)
    events = LIVE_EVENTS + [LIVE_STEP] * LIVE_STEADY
    split = {"render (K1 + K2, events)": [], "quantize (events)": [], "copy to host": [],
             "PNG encode": []}
    pairs, presented = [], []

    def events_ms(fn, label):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        pairs.append((label, a, b))
        return out, b

    def render(*args):
        return events_ms(lambda: cuda_renderer.render(*args), "render (K1 + K2, events)")[0]

    def to_u8(img):
        u8, done = events_ms(lambda: live.to_u8(img), "quantize (events)")
        done.synchronize()
        presented.append((img, u8))
        return u8

    def host_clock(fn, label):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            split[label].append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    encode = live.encode_png
    srv = LiveFrameServer(FrameLoop(cfg, scene, render_fn=render))
    srv._to_u8, srv._to_host = to_u8, host_clock(live.to_host, "copy to host")
    live.encode_png = host_clock(encode, "PNG encode")
    reset_launches()
    try:
        replies = [post_step(srv.url, ev) for ev in events]
        torch.cuda.synchronize()
        counts = launch_counts()
        state = srv.state()
    finally:
        live.encode_png = encode
        srv.close()
    for label, a, b in pairs:
        split[label].append(a.elapsed_time(b))

    want_status = [204 if k in (4, 5) else 200 for k in range(len(events))]
    n = want_status.count(200)
    loop, prev, offline = FrameLoop(cfg, scene), None, []
    for ev in events:
        img = loop.step(InputEvent(**ev))
        if img is not prev:
            offline.append(to_srgb_u8(img.cpu().numpy()))
        prev = img
    wire = [png_of(body) for status, body, _, _ in replies if status == 200]
    same = len(wire) == len(offline) == n and all(np.array_equal(a, b)
                                                   for a, b in zip(wire, offline))
    on_card = all(np.array_equal(u8.cpu().numpy(), to_srgb_u8(img.cpu().numpy()))
                  for img, u8 in presented)
    idx = [int(h["X-Frame-Index"]) for status, _, h, _ in replies if status == 200]
    split["HTTP round trip (client)"] = [r[3] for r in replies]
    med = {k: float(np.median(v[-LIVE_STEADY:])) for k, v in split.items()}
    log(f"  live: {len(events)} events, statuses {[r[0] for r in replies]}; {len(wire)} wire "
        f"frames bit for bit an offline card FrameLoop's: {same}; on-card u8 == to_srgb_u8 "
        f"on all {len(presented)}: {on_card}; launches {counts} (expected K1 = K2 = {n})")
    log(f"  live /step split at {cfg.width}x{cfg.height}, medians of the {LIVE_STEADY} steady "
        f"steps: " + ", ".join(f"{k} {v:.4f} ms" for k, v in med.items())
        + f"; PNG {len(replies[-1][1])} B [{card}]")
    # the card waits for the host at every step, so the spans above hold
    # launch latency; the device's own time for the same work:
    frame, pose = presented[-1][0], loop._pose()
    q_ev, q_host = cuda_ms(lambda k: live.to_u8(frame), 20)
    q_dev = profiled_device_ms(lambda: live.to_u8(frame), "")
    _, r_dev = kernel_device_ms(lambda: cuda_renderer.render(cfg, scene, *pose))
    log(f"  live device time a step: render K1 {r_dev.get('K1', float('nan')):.4f} + K2 "
        f"{r_dev.get('K2', float('nan')):.4f} ms (profiler); quantize "
        f"{q_dev if q_dev is not None else float('nan'):.4f} ms (profiler), {q_ev:.4f} ms a call "
        f"by events back to back ({q_host:.4f} ms host enqueue) [{card}]")
    if ([r[0] for r in replies] != want_status or not same or not on_card
            or idx != list(range(n)) or state["frame"] != n - 1
            or counts != {"K1": n, "K2": n}):
        raise AssertionError("the live server's frames, statuses or launches are wrong")
    return counts


def run_cli(argv) -> dict:
    """cli.main(argv) in process under the launch counters; its output is
    logged. -> the launch counts."""
    import io

    from raytracing_engine_tpu_torch import cli

    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main([str(a) for a in argv])
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"  $ cli {' '.join(str(a) for a in argv)}")
    for line in buf.getvalue().strip().splitlines():
        log(f"    | {line}")
    return counts


def check_cli(label, counts, want, files, kern_ms, frames, card):
    """Log one command's result; raise unless its launches are `want` and
    every file is bit for bit its direct call ({name: (got, want)})."""
    same = {name: np.array_equal(got, ref) for name, (got, ref) in files.items()}
    per_frame = ", ".join(f"{k} {v / frames:.4f} ms" for k, v in sorted(kern_ms.items()))
    log(f"  {label}: launches {counts} (expected {want}); bit for bit the direct call: "
        f"{same}; the direct call's kernels by the profiler, a frame: "
        f"{per_frame or 'not measured'} [{card}]")
    if counts != want or not all(same.values()):
        raise AssertionError(f"cli {label}: launches {counts} != {want} or files {same}")


def phase_cli(device, card) -> dict:
    """(b) and (c) of phase 21. -> launch counts summed over the commands."""
    import raytracing_engine_tpu_torch as rtt
    from raytracing_engine_tpu_torch.accel import (
        build_bvh,
        build_clusters,
        grid_instances,
        torus_knot,
    )
    from raytracing_engine_tpu_torch.camera import Camera, orbit_path
    from raytracing_engine_tpu_torch.models import cuda_renderer
    from raytracing_engine_tpu_torch.models.instanced import render_instanced_phong
    from raytracing_engine_tpu_torch.ops.cuda.instanced import pack_instances
    from raytracing_engine_tpu_torch.ops.cuda.pt import render_pt_mega, render_pt_rebin
    from raytracing_engine_tpu_torch.ops.rng_pcg import prng_key_data
    from raytracing_engine_tpu_torch.pathtracer import (
        PTConfig,
        denoise,
        load_scene_json,
        render_aovs,
        render_pt_fast,
        scenes,
    )
    from raytracing_engine_tpu_torch.runtime import FrameLoop, load_replay, save_replay
    from raytracing_engine_tpu_torch.utils import tonemap, write_png
    from raytracing_engine_tpu_torch.utils.image import to_srgb_u8
    from raytracing_engine_tpu_torch.utils.video import read_apng

    out = CLI_OUT
    size = f"{SIZE[0]}x{SIZE[1]}"
    key = prng_key_data(0)  # the CLI's default --seed
    cfg = rtt.RenderConfig(*SIZE)
    scene = rtt.default_scene(device)
    total = {}

    def tally(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return counts

    def u8(t):
        return to_srgb_u8(t.cpu().numpy())

    # render: K1 and K2
    counts = tally(run_cli(["render", "--size", size, "--out", out / "render"]))
    cam = Camera.initial()
    img, ms = kernel_device_ms(lambda: cuda_renderer.render(
        cfg, scene, cam.position.to(device), cam.quat().to(device)))
    render_png = png_of(out / "render" / "frame_0000.png")
    check_cli("render", counts, {"K1": 1, "K2": 1}, {"frame_0000.png": (render_png, u8(img))},
              ms, 1, card)

    # orbit: to an APNG, then --resume over a directory holding frames 0 and 2
    positions, rotations = orbit_path(CLI_ORBIT)
    orbit = ["orbit", "--size", size, "--frames", CLI_ORBIT, "--chunk", 2]
    counts_a = tally(run_cli(orbit + ["--apng", out / "orbit.apng"]))
    frames, _ = read_apng(str(out / "orbit.apng"))
    (out / "orbit").mkdir(exist_ok=True)
    for i in (0, 2):
        write_png(str(out / "orbit" / f"frame_{i:04d}.png"), frames[i])
    counts_r = tally(run_cli(orbit + ["--out", out / "orbit", "--resume"]))
    cams = [Camera(positions[i], rotations[i]) for i in range(CLI_ORBIT)]
    imgs, ms = kernel_device_ms(lambda: [cuda_renderer.render(
        cfg, scene, c.position.to(device), c.quat().to(device)) for c in cams])
    want = [u8(t) for t in imgs]
    check_cli("orbit --apng", counts_a, {"K1": CLI_ORBIT, "K2": CLI_ORBIT},
              {f"APNG frame {i}": (frames[i], want[i]) for i in range(CLI_ORBIT)}, ms,
              CLI_ORBIT, card)
    check_cli("orbit --resume", counts_r, {"K1": 2, "K2": 2},
              {f"frame_{i:04d}.png": (png_of(out / "orbit" / f"frame_{i:04d}.png"),
                                      want[i]) for i in range(CLI_ORBIT)}, ms, CLI_ORBIT, card)

    # replay of phase 17's stream (chunked, as the CLI defaults)
    path = out / "session.replay"
    save_replay(str(path), replay_stream())
    counts = tally(run_cli(["replay", path, "--size", size, "--monitor",
                            f"{REPLAY_MONITOR[0]}x{REPLAY_MONITOR[1]}", "--out",
                            out / "replay"]))
    offline = {}
    loop = FrameLoop(cfg, scene, monitor=REPLAY_MONITOR)
    _, ms = kernel_device_ms(lambda: loop.run(load_replay(str(path)),
                                              sink=offline.__setitem__))
    rendered = [i for i in range(REPLAY_EVENTS) if i not in (6, 7, 8)]
    names = sorted(p.name for p in (out / "replay").iterdir())
    if names != [f"frame_{i:04d}.png" for i in rendered]:
        raise AssertionError(f"cli replay wrote {names}")
    check_cli("replay", counts, {"K1": len(rendered), "K2": len(rendered)},
              {f"frame_{i:04d}.png": (png_of(out / "replay" / f"frame_{i:04d}.png"),
                                      to_srgb_u8(offline[i])) for i in rendered}, ms,
              len(rendered), card)

    # pt on the showcase with --bvh: a ClusterSet on the card, auto -> rebin (K5)
    pt_cfg = PTConfig(width=SIZE[0], height=SIZE[1], max_bounces=4, rng="pcg")
    counts = tally(run_cli(["pt", "--scene", SHOWCASE, "--bvh", "--size", size, "--spp",
                            SHOW_SPP, "--out", out / "showcase.png"]))
    b = load_scene_json(str(SHOWCASE), device=device)
    cs = build_clusters(b.tris, tri_mats=b.tri_mats, vertex_normals=b.tri_normals,
                        vertex_uvs=b.tri_uvs, device=device)
    pos, quat = (torch.from_numpy(v).to(device) for v in (b.cam_pos, b.cam_quat))
    (img, _), ms = kernel_device_ms(
        lambda: render_pt_rebin(pt_cfg, b.scene, pos, quat, SHOW_SPP, key, bvh=cs))
    k5 = SHOW_SPP * (pt_cfg.max_bounces + 1)
    check_cli("pt showcase --bvh (rebin)", counts, {"K5": k5, "K5 material": k5},
              {"showcase.png": (png_of(out / "showcase.png"), u8(img))}, ms, 1, card)

    # pt --mega on the Cornell box: K4 without a mesh
    cornell = scenes.cornell_box(device=device)
    pos = torch.tensor([0.0, 0.2, 0.0], device=device)
    quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    counts = tally(run_cli(["pt", "--scene", "cornell", "--mega", "--size", "512x512",
                            "--spp", CLI_MEGA_SPP, "--out", out / "cornell_mega.png"]))
    mega_cfg = PTConfig(width=512, height=512, max_bounces=4, rng="pcg")
    (img, _), ms = kernel_device_ms(
        lambda: render_pt_mega(mega_cfg, cornell, pos, quat, CLI_MEGA_SPP, key))
    check_cli("pt cornell --mega", counts, {"K4": 1, "K4 none": 1},
              {"cornell_mega.png": (png_of(out / "cornell_mega.png"), u8(img))},
              ms, 1, card)

    # pt --denoise --aov --tonemap aces --gamma 2.2: the wavefront, K9's AOV jitter
    stem = out / "cornell_dn"
    counts = tally(run_cli(["pt", "--scene", "cornell", "--spp", CLI_DENOISE_SPP, "--denoise",
                            "--aov", "--tonemap", "aces", "--gamma", 2.2,
                            "--out", f"{stem}.png"]))
    dn_cfg = PTConfig(width=256, height=256, max_bounces=4, rng="pcg")

    def denoised():
        img, _ = render_pt_fast(dn_cfg, cornell, pos, quat, CLI_DENOISE_SPP, key)
        img = img.cpu().numpy()
        g = render_aovs(dn_cfg, cornell, pos, quat, CLI_DENOISE_SPP, key)
        img = denoise(torch.from_numpy(img).to(device), g["albedo"], g["normal"],
                      g["depth"]).cpu().numpy()
        aovs = {k: v.cpu().numpy()
                for k, v in render_aovs(dn_cfg, cornell, pos, quat, CLI_DENOISE_SPP,
                                        key).items()}
        return tonemap(img, "aces", 1.0, 2.2), aovs

    (beauty, aovs), ms = kernel_device_ms(denoised)
    dep = aovs["depth"]
    lo, hi = dep[dep > 0].min() if (dep > 0).any() else 0.0, dep.max()
    dvis = np.where(dep > 0, 1.0 - (dep - lo) / max(hi - lo, 1e-6), 0.0)
    want = {"": beauty, "_albedo": aovs["albedo"], "_normal": aovs["normal"] * 0.5 + 0.5,
            "_depth": np.repeat(dvis[..., None], 3, -1)}
    check_cli("pt cornell --denoise --aov", counts, {"K9": 2 * CLI_DENOISE_SPP},
              {f"cornell_dn{k}.png": (png_of(f"{stem}{k}.png"), to_srgb_u8(v))
               for k, v in want.items()}, ms, 1, card)

    # instanced: config 5's grid through K7
    counts = tally(run_cli(["instanced", "--size", size, "--frames", CLI_INSTANCED,
                            "--out", out / "instanced"]))
    knot = torus_knot(segments=550, sides=32)
    base = build_clusters(knot, device=device)
    inst = grid_instances(build_bvh(knot, device=device), nx=6, ny=5, spacing=4.0,
                          base=(0.0, 14.0, 0.0), mats=np.arange(30, dtype=np.int32) % 3,
                          device=device)
    alb = torch.tensor([[0.8, 0.5, 0.3], [0.4, 0.7, 0.5], [0.5, 0.5, 0.8]], device=device)
    light = torch.tensor([6.0, 2.0, 8.0], device=device)
    tab = pack_instances(inst)
    yaws = [np.float32(0.5 * i / max(CLI_INSTANCED - 1, 1)) for i in range(CLI_INSTANCED)]
    imgs, ms = kernel_device_ms(lambda: [render_instanced_phong(
        tab, base, inst.mat, alb, torch.zeros(3, device=device), y, light, width=SIZE[0],
        height=SIZE[1]) for y in yaws])
    check_cli("instanced", counts, {"K7": 2 * CLI_INSTANCED},
              {f"frame_{i:04d}.png": (png_of(out / "instanced" / f"frame_{i:04d}.png"),
                                      u8(imgs[i])) for i in range(CLI_INSTANCED)}, ms,
              CLI_INSTANCED, card)

    # (c) the module entry point with no --device: the card by default
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "raytracing_engine_tpu_torch.cli", "render",
                           "--size", size, "--out", str(out / "module")], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    log(f"  $ python3 -m raytracing_engine_tpu_torch.cli render --size {size}: exit "
        f"{proc.returncode} in {time.perf_counter() - t0:.1f} s: {proc.stdout.strip()}")
    if proc.returncode != 0:
        raise AssertionError(f"the module entry point failed:\n{proc.stderr[-4000:]}")
    same = np.array_equal(png_of(out / "module" / "frame_0000.png"), render_png)
    log(f"  its PNG bit for bit (b)'s render: {same}")
    if not same:
        raise AssertionError("python3 -m raytracing_engine_tpu_torch.cli render differs")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    import raytracing_engine_tpu_torch as rtt

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t0 = time.perf_counter()

    log("phase 1: card and build")
    card = card_line()
    log(f"  card: {card}")
    phase_build()

    cfg = rtt.RenderConfig(width=SIZE[0], height=SIZE[1])
    scene = rtt.default_scene(device)
    z = np.load(GOLDEN)
    pos = torch.from_numpy(z["pos"]).to(device)
    quat = torch.from_numpy(z["quat"]).to(device)

    log(f"phase 2: kernels vs plain versions at {cfg.width}x{cfg.height}, "
        f"levels {list(cfg.level_dims)}")
    errs = phase_kernels(cfg, scene, pos, quat)
    log("phase 3: fused vs two-kernel")
    phase_fused_bitwise(cfg, scene, pos, quat)
    log("phase 4: 64x64 against tests/golden/golden_64.npz")
    golden_msg = phase_golden(device)
    log(f"phase 5: main path at {cfg.width}x{cfg.height} (FrameLoop, render_sequence)")
    counts, png_msg = phase_main_path(cfg, scene)
    log("phase 6: timing (CUDA events)")
    times = phase_timing(cfg, scene, card)

    pt_quat, pt_seed, c2, c4 = pt_setup(device)
    log("phase 7: K4 vs its plain version (BASELINE configs 2 and 4)")
    pt_err = phase_pt_kernel(pt_quat, pt_seed, c2, c4)
    log("phase 8: path-tracer physics and invariants through K4")
    phase_pt_invariants(pt_quat, pt_seed, c2, c4, device)
    log("phase 9: path-tracer main path and timing (CUDA events)")
    pt_main = phase_pt_main(pt_quat, pt_seed, c2, c4, card, device)

    c3 = c3_setup(device)
    log("phase 10: BASELINE config 3's ClusterSet and K6 vs its plain version")
    k6 = phase_cluster_kernel(c3, pt_quat, pt_seed, device, card)
    log("phase 11: config 3 through K4, K5 and K6, and its invariants")
    inv = phase_c3_invariants(c3, pt_quat, pt_seed, device)
    k6["max_abs_err"] = max(k6["max_abs_err"], phase_c3_warp_rays(c3, pt_quat, pt_seed, device))
    log("phase 12: config-3 main path and timing (CUDA events)")
    c3_main = phase_c3_main(c3, pt_quat, pt_seed, device, card, inv)
    log("phase 13: config 3's raw BVH and K8 vs its plain version")
    k8, bvh3 = phase_bvh_kernel(c3, pt_quat, pt_seed, device, card)
    c5 = c5_setup(device)
    log("phase 14: BASELINE config 5, K7 and the instanced paths vs their plain versions")
    k7_err, k4_inst = phase_instanced_kernel(c5, pt_quat, pt_seed, device)
    k7_err = max(k7_err, phase_c5_warp_rays(c5, pt_quat, pt_seed, device))
    log("phase 15: the slice's main paths and timing (CUDA events)")
    c5_main = phase_c5_main(c5, c3, bvh3, pt_quat, pt_seed, device, card, k4_inst)
    log("phase 16: kernel K9 and the threefry and pallas streams")
    k9 = phase_rng(pt_quat, c2, c4, c3, bvh3, device, card)
    t17 = time.perf_counter()
    log(f"phase 17: input replay and video output on the cone-march path at "
        f"{cfg.width}x{cfg.height}")
    replay = phase_replay(cfg, scene, card)
    t18 = time.perf_counter()
    log("phase 18: the AOV / temporal / denoise path and the denoised temporal orbit")
    orbit, orbit_k4_err = phase_postprocess(c3, bvh3, device, card)
    log(f"phases 17 and 18: {t18 - t17:.1f} s and {time.perf_counter() - t18:.1f} s; launches "
        f"on their main paths: replay {replay}, orbit {orbit}")
    log("phase 19: the showcase scene (examples/showcase.json) through K4, K5 and K6")
    show = phase_showcase(device, card)
    log("phase 20: the showcase with the env map, rough glass and UV textures")
    rest = phase_showcase_rest(device, card)
    t21 = time.perf_counter()
    log(f"phase 21: the entry points at {cfg.width}x{cfg.height}: the live server and the "
        "command line")
    entry = phase_live(cfg, scene, card)
    for k, v in phase_cli(device, card).items():
        entry[k] = entry.get(k, 0) + v
    log(f"phase 21: {time.perf_counter() - t21:.1f} s; launches on its paths {entry}")
    log("phase 22: the texture features (normal maps, mips and trilinear filtering, UV "
        "tables under instances) through K4, K5, K6 and K7")
    tex = phase_textures(device, card)
    log("phase 23: the sampling features (thin-lens depth of field, the R_d sampler, adaptive "
        "spp) through K4 and K5")
    samp = phase_sampling(device, card)
    log("phase 24: the light features (fog and single-scatter media, the light tree, mesh "
        "lights per pass and per lane) through K4 and K5")
    lights = phase_lights(device, card)

    # no single PyTorch call computes any of these kernels (torch.rand draws
    # Philox, not threefry): library_ms null
    src = "raytracing_engine_tpu_torch/csrc/conemarch.cu"
    kernels = [
        {"name": "pyramid_kernel (K1)", "route": "cuda", "source": src,
         "replaces": "raytracing_engine_tpu/ops/pallas/depth.py:98",
         "launches": counts["depth"] + replay["K1"] + entry.get("K1", 0),
         "max_abs_err": errs["depth"],
         **times["depth"],
         "library_ms": None},
        {"name": "fused_kernel (K2)", "route": "cuda", "source": src,
         "replaces": "raytracing_engine_tpu/ops/pallas/fused.py:30",
         "launches": counts["fused"] + replay["K2"] + entry.get("K2", 0),
         "max_abs_err": errs["fused"],
         **times["fused"],
         "library_ms": None},
        {"name": "shade_kernel (K3)", "route": "cuda", "source": src,
         "replaces": "raytracing_engine_tpu/ops/pallas/shade.py:194",
         "launches": counts["shade"] + entry.get("K3", 0), "max_abs_err": errs["shade"],
         **times["shade"],
         "library_ms": None},
        {"name": "pt_kernel<none> (K4)", "route": "cuda",
         "source": "raytracing_engine_tpu_torch/csrc/pt.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/pt_kernel.py:194",
         "max_abs_err": pt_err, **pt_main,
         "launches": pt_main["launches"] + entry.get("K4 none", 0), "library_ms": None},
        {"name": "pt_kernel<clusters> (K4)", "route": "cuda",
         "source": "raytracing_engine_tpu_torch/csrc/pt.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/pt_kernel.py:194",
         "launches": c3_main["launches"]["K4"] + orbit["K4"], **c3_main["k4"],
         "max_abs_err": max(c3_main["k4"]["max_abs_err"], orbit_k4_err), "library_ms": None},
        {"name": "pt_kernel<instances> (K4)", "route": "cuda",
         "source": "raytracing_engine_tpu_torch/csrc/pt.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/pt_kernel.py:194",
         "launches": c5_main["launches"]["K4"], **c5_main["k4"], "library_ms": None},
        {"name": "pt_kernel<clusters, material> (K4)", "route": "cuda",
         "source": "raytracing_engine_tpu_torch/csrc/pt.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/pt_kernel.py:194", **show["k4"],
         "library_ms": None},
        {"name": "pt_rebin_kernel (K5)", "route": "cuda",
         "source": "raytracing_engine_tpu_torch/csrc/pt.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/pt_kernel.py:699",
         "launches": c3_main["launches"]["K5"] + entry.get("K5", 0)
         - entry.get("K5 material", 0), "max_abs_err": inv["max_abs_err"],
         **c3_main["k5"], "library_ms": None},
        {"name": "pt_kernel<clusters, material> (K4, env map, rough glass, UV textures)",
         "route": "cuda", "source": "raytracing_engine_tpu_torch/csrc/pt.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/pt_kernel.py:194", **rest["k4"],
         "library_ms": None},
        {"name": "pt_rebin_kernel<material> (K5)", "route": "cuda",
         "source": "raytracing_engine_tpu_torch/csrc/pt.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/pt_kernel.py:699", **show["k5"],
         "launches": show["k5"]["launches"] + entry.get("K5 material", 0),
         "library_ms": None},
        {"name": "pt_rebin_kernel<material> (K5, env map, rough glass, UV textures)",
         "route": "cuda", "source": "raytracing_engine_tpu_torch/csrc/pt.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/pt_kernel.py:699", **rest["k5"],
         "library_ms": None},
        {"name": "cluster_kernel (K6)", "route": "cuda",
         "source": "raytracing_engine_tpu_torch/csrc/cluster.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/cluster_intersect.py:439",
         "launches": c3_main["launches"]["K6"] + orbit["K6"] + show["K6"] + rest["K6"]
         + entry.get("K6", 0), **k6,
         "library_ms": None},
        {"name": "instanced_kernel (K7)", "route": "cuda",
         "source": "raytracing_engine_tpu_torch/csrc/instanced.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/instanced_intersect.py:225",
         "launches": c5_main["launches"]["K7"] + entry.get("K7", 0),
         "max_abs_err": max(k7_err, c5_main["k7_err"]), **c5_main["k7"],
         "library_ms": None},
        {"name": "traverse_kernel (K8)", "route": "cuda",
         "source": "raytracing_engine_tpu_torch/csrc/bvh.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/bvh_traverse.py:60",
         "launches": c5_main["launches"]["K8"] + entry.get("K8", 0), **k8,
         "library_ms": None},
        {"name": "rng_kernel (K9)", "route": "cuda",
         "source": "raytracing_engine_tpu_torch/csrc/rng.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/rng.py:24", **k9,
         "launches": k9["launches"] + orbit["K9"] + entry.get("K9", 0), "library_ms": None},
        *tex,
        *samp,
        *lights,
    ]
    for k in kernels:  # a timing that failed fails the run
        bad = [key for key in ("ms", "plain_ms", "bound_ms", "max_abs_err")
               if key in k and not math.isfinite(k[key])]
        if bad:
            raise AssertionError(f"{k['name']}: {bad} not finite")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(f"image output: {golden_msg}; {png_msg}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
