"""A second witness for chip_smoke.py phase 18 (c)'s full-size reading: the
JAX package's temporal_step, and the port's, on the CPU over the card's
inputs of a band of rows.

At a static pose the temporal output should be the running mean of the
frames. chip_smoke.py reads how far it is at 1920x1088 on the card and
writes ``smoke_out/static_hd_band.npz``: a band of rows around the worst
pixel of that reading, holding the six frames' radiance and AOV planes,
the pose, and the card's output and history length there. This script puts
each frame's rows into an otherwise empty frame of the full size (depth 0:
no hit) and runs the six temporal_steps of both packages on the CPU. A
pixel's output depends on its own inputs and, through the bilinear history
lookup and the depth gradient, on pixels at most one row away per step, so
the rows at least one more than the step count from the band's edges are
those of the full frame: only they are read.

    JAX_PLATFORMS=cpu python tests/witness_static_hd.py smoke_out/static_hd_band.npz

It prints, for JAX, the port on the CPU and the card, the largest
|output - running mean| / max(1, the pixel's largest frame value) over the
pixels kept every frame, with its pixel; the pixels whose history length
differs from the card's (a validity test decided the other way: the
packages round the reprojection differently in the last bit); and how far
the output is from the card's on the others.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def reading(out, img, length, rows):
    """(ratio, absolute error, (y, x)) of the worst full-history pixel of
    `out` within `rows`; img: the frames (n, rows, W, 3)."""
    n = img.shape[0]
    stack = img.astype(np.float64)
    scale = np.maximum(np.abs(stack).max(axis=(0, -1)), 1.0)
    error = np.abs(out.astype(np.float64) - stack.mean(0)).max(-1)
    ratio = np.where(length == float(n), error / scale, -1.0)
    ratio[:rows.start] = ratio[rows.stop:] = -1.0
    at = np.unravel_index(int(ratio.argmax()), ratio.shape)
    return ratio[at], error[at], (int(at[0]), int(at[1]))


def run(step, init, frames, size, row0, pos, quat, to_host):
    """The temporal_steps of one package over full frames holding the
    band's rows; -> (output, history length) of the band's rows."""
    width, height = size
    state = init
    for f in frames:
        full = {k: np.zeros((height,) + v.shape[1:], np.float32) for k, v in f.items()}
        for k, v in f.items():
            full[k][row0:row0 + v.shape[0]] = v
        aovs = {k: full[k] for k in ("albedo", "normal", "depth")}
        state, out = step(state, full["img"], aovs, pos, quat)
    band = slice(row0, row0 + frames[0]["img"].shape[0])
    return to_host(out)[band], to_host(state.length)[band]


def main(path: str) -> int:
    import jax.numpy as jnp
    import torch

    from raytracing_engine_tpu.pathtracer import temporal as jt
    from raytracing_engine_tpu.pathtracer.integrator import PTConfig as JaxConfig
    from raytracing_engine_tpu_torch.pathtracer import PTConfig, temporal_init, temporal_step

    z = np.load(path)
    width, height, bounces = (int(v) for v in z["size"])
    row0, n_keys, band_h = int(z["row0"]), z["img"].shape[0], z["img"].shape[1]
    frames = [{k: z[k][i] for k in ("img", "albedo", "normal", "depth")} for i in range(n_keys)]
    rows = slice(n_keys + 1, band_h - n_keys - 1)
    pos, quat = z["pos"], z["quat"]

    jcfg = JaxConfig(width=width, height=height, max_bounces=bounces)
    jax_out, jax_len = run(
        lambda s, img, aovs, p, q: jt.temporal_step(
            jcfg, s, jnp.asarray(img), {k: jnp.asarray(v) for k, v in aovs.items()},
            jnp.asarray(p), jnp.asarray(q)),
        jt.temporal_init(jcfg), frames, (width, height), row0, pos, quat, np.asarray)
    cfg = PTConfig(width=width, height=height, max_bounces=bounces)
    cpu = torch.device("cpu")
    port_out, port_len = run(
        lambda s, img, aovs, p, q: temporal_step(cfg, s, img, aovs, p, q, device=cpu),
        temporal_init(cfg, device=cpu), frames, (width, height), row0, pos, quat,
        lambda t: t.numpy())

    y, x = (int(v) for v in z["worst"])
    print(f"{path}: {n_keys} frames at {width}x{height}, rows {row0}..{row0 + band_h} "
          f"(read {row0 + rows.start}..{row0 + rows.stop}); the card's worst full-size pixel "
          f"(y {y}, x {x}) at ratio {float(z['ratio']):.4g}")
    for name, out, length in (("JAX temporal_step (CPU)", jax_out, jax_len),
                              ("port temporal_step (CPU)", port_out, port_len),
                              ("port temporal_step (card)", z["out"], z["length"])):
        ratio, err, (yy, xx) = reading(out, z["img"], length, rows)
        flip = length[rows] != z["length"][rows]
        off = np.abs(out - z["out"])[rows].max(-1)
        cols = sorted({int(c) for c in np.nonzero(flip)[1]})
        print(f"  {name}: max |output - running mean| / max(1, largest frame value) {ratio:.4g} "
              f"(absolute {err:.4g}) at (y {row0 + yy}, x {xx}); history length other than the "
              f"card's on {int(flip.sum())} of {flip.size} pixels (columns {cols}); max |output - "
              f"card's| {off[~flip].max():.3g} where it is the card's")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "smoke_out/static_hd_band.npz"))
