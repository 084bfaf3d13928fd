"""K1: the depth pyramid through the CUDA kernel ``pyramid_kernel``
(csrc/conemarch.cu), which replaces raytracing_engine_tpu/ops/pallas/depth.py
``_depth_kernel``. One launch marches levels first..last: a block a
TILE_W x TILE_H tile of a level, taken in level order, and a tile waits only
for the tile of the level before that holds its pixels' parents [y/2, x/2]
(``pyramid_items`` gives the plan, which the kernel follows).
``depth_level`` is the one-level case, seeded from the previous level's
tensor; ``depth_pyramid`` marches levels 0..last in one launch.

A scene on the CPU takes the plain version; a scene on a CUDA device launches
the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from raytracing_engine_tpu_torch.models import conemarch
from raytracing_engine_tpu_torch.ops.cuda import common

# kernel launches since the count was last set to 0 (plain-version calls
# do not count)
launches = 0

# a block's tile of a level: csrc/conemarch.cu kTileX x kTileY
TILE_W = 4
TILE_H = 8

# (device, stream) -> [the sync buffer (ticket and done counters, then a
# flag a tile), the epoch of its last launch]; one a stream, as the counters
# serve one launch at a time
_sync: dict = {}


def pyramid_items(dims, first: int, last: int) -> tuple[list, int]:
    """(first tile of each level first..last, tiles in all) of a launch,
    dims the (w, h) of each level: TILE_W x TILE_H tiles, level-major and
    row-major within a level. Tile (bx, by) of level l > first waits for
    tile (bx // 2, by // 2) of level l - 1, which comes before it."""
    starts, n = [], 0
    for w, h in dims[first:last + 1]:
        starts.append(n)
        n += -(-w // TILE_W) * -(-h // TILE_H)
    return starts, n


def sync_buffer(device, items: int) -> tuple[torch.Tensor, int]:
    """The current stream's sync buffer, with room for `items` flags, and a
    new epoch for the launch."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    entry = _sync.get(key)
    if entry is None or entry[0].numel() < 2 + items:
        entry = [torch.zeros(2 + items, dtype=torch.int32, device=device),
                 entry[1] if entry else 0]
        _sync[key] = entry
    entry[1] = entry[1] % (2**31 - 1) + 1
    return entry[0], entry[1]


@functools.lru_cache(maxsize=16)
def level_table(cfg) -> tuple:
    """(w, h, img_sx, img_sy, threshold) lists of every level of cfg."""
    dims = cfg.level_dims
    size = [cfg.level_image_size(i) for i in range(cfg.level_count)]
    return ([w for w, _ in dims], [h for _, h in dims], [s[0] for s in size],
            [s[1] for s in size], [cfg.level_threshold(i) for i in range(cfg.level_count)])


def check_prev_level(cfg, level: int, prev) -> None:
    """Raise ValueError unless `prev` is None or exactly level - 1 of cfg's
    pyramid, as an (h, w) tensor. In this place JAX's launchers
    (depth_level_pallas, depth_shade_fused) take the level's full-resolution
    seed, upsample_seed(prev, h, w): it is large enough to be read at
    [y // 2, x // 2], so without this check it would seed every pixel from
    its grandparent level and render another image without a word."""
    if prev is None:
        return
    w, h = cfg.level_dims[level]
    shape = tuple(prev.shape)
    if level == 0:
        raise ValueError(f"level 0 ({h}, {w}) cannot be seeded from {shape}: it has no "
                         "previous level (pass None, seed 1); JAX's full-resolution `seed` is "
                         "not this argument")
    pw, ph = cfg.level_dims[level - 1]
    if shape != (ph, pw):
        raise ValueError(f"level {level} ({h}, {w}) cannot be seeded from {shape}: `prev` is the "
                         f"previous level, shape ({ph}, {pw}), not JAX's full-resolution `seed` "
                         f"({h}, {w}) = upsample_seed(prev, {h}, {w})")


def depth_level_reference(cfg, level: int, scene, cam_pos, cam_quat, prev=None):
    """Plain PyTorch version: ray-gen, seed upsample and the whole-image cone
    march of models/conemarch.py → (h, w)."""
    return conemarch.render_depth_level(cfg, level, scene, cam_pos, cam_quat, prev)


def march_levels_reference(cfg, first: int, last: int, scene, cam_pos, cam_quat, prev=None):
    """Plain version of march_levels: the plain levels one after another."""
    levels = []
    for i in range(first, last + 1):
        prev = depth_level_reference(cfg, i, scene, cam_pos, cam_quat, prev)
        levels.append(prev)
    return tuple(levels)


def march_levels(cfg, first: int, last: int, scene, cam_pos, cam_quat, prev=None):
    """Levels first..last in one launch → a tuple of (h, w) float32 tensors.
    prev: the level before `first`, exactly (check_prev_level), or None
    (seed 1, the near plane, as at level 0)."""
    global launches
    if not 0 <= first <= last < cfg.level_count:
        raise ValueError(f"levels {first}..{last} of a {cfg.level_count}-level pyramid")
    check_prev_level(cfg, first, prev)
    if scene.device.type == "cpu":
        return march_levels_reference(cfg, first, last, scene, cam_pos, cam_quat, prev)
    if cfg.level_count > common.MAX_LEVELS:
        raise ValueError(f"{cfg.level_count} levels: one launch marches at most "
                         f"{common.MAX_LEVELS}")
    dims = cfg.level_dims
    args = common.scene_args(cfg, scene, cam_pos, cam_quat, last)
    common.set_seed_source(args, prev, dims[first][1], dims[first][0], scene.device)
    sizes = [w * h for w, h in dims[first:last + 1]]
    offsets = [sum(sizes[:k]) for k in range(len(sizes))]
    out = torch.empty(sum(sizes), dtype=torch.float32, device=scene.device)
    ws, hs, sx, sy, thr = level_table(cfg)
    n = cfg.level_count
    starts, items = pyramid_items(dims, first, last)
    sync, epoch = sync_buffer(scene.device, items)
    args.out, args.w, args.h = out.data_ptr(), *dims[last]
    args.first, args.last, args.items, args.epoch = first, last, items, epoch
    args.sync = sync.data_ptr()
    args.lvl_item[first:last + 1] = starts
    args.lvl_w[:n], args.lvl_h[:n] = ws, hs
    args.lvl_sx[:n], args.lvl_sy[:n], args.lvl_thr[:n] = sx, sy, thr
    args.lvl_off[first:last + 1] = offsets
    common.launch("conemarch_pyramid", args)
    launches += 1
    return tuple(out[o:o + s].view(h, w)
                 for o, s, (w, h) in zip(offsets, sizes, dims[first:last + 1]))


def depth_level(cfg, level: int, scene, cam_pos, cam_quat, prev=None):
    """One pyramid level → (h, w) float32. prev: the previous level,
    exactly cfg.level_dims[level - 1] as (h, w), or None (seed 1, the near
    plane, as at level 0). JAX's depth_level_pallas takes the level's
    full-resolution seed in this place; it is refused (check_prev_level)."""
    return march_levels(cfg, level, level, scene, cam_pos, cam_quat, prev)[0]


def depth_pyramid(cfg, scene, cam_pos, cam_quat, last: int | None = None):
    """Levels 0..last (None: the finest) in one launch: a tuple of (h, w)
    tensors, coarse → fine."""
    last = cfg.level_count - 1 if last is None else last
    return march_levels(cfg, 0, last, scene, cam_pos, cam_quat)
