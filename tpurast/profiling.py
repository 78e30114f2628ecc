"""Per-stage device timing for the production frame pipeline.

The reference's only profiling mechanism is the per-frame wall-clock
overlay (src/Engine.zig:190-195, src/Renderer.zig:1182-1207); a tiled
software rasterizer needs more: stage_sweep() times jit-compiled
PREFIXES of render_frame via its `stage=` parameter, so the deltas
between successive prefixes are per-stage device costs on the exact
production path (including whatever XLA overlaps across stage
boundaries). Every timed frame ends in block_until_ready. Used by
`tpurast-bench --stages` (stage_ms in the bench JSON) and
tools/profile_stages.py.
"""

from __future__ import annotations

import functools
import time

import numpy as np

#: Prefix order; None = the full frame (shade + sRGB encode).
STAGES = [
    "geometry",
    "binning",
    "segments",
    "raster",
    "resolve",
    None,
]


def time_frames(fn, scene, uniforms, warmup=4, frames=32):
    """p50 per-frame ms of fn(scene, *u), each frame synced with
    block_until_ready."""
    import jax

    for u in uniforms[:warmup]:
        jax.block_until_ready(fn(scene, *u))
    times = []
    for u in uniforms[warmup : warmup + frames]:
        t0 = time.perf_counter()
        jax.block_until_ready(fn(scene, *u))
        times.append(time.perf_counter() - t0)
    return float(np.percentile(np.asarray(times) * 1e3, 50))


def stage_sweep(renderer, uniforms, frames=32):
    """p50 device ms for each pipeline prefix of `renderer`'s config.

    Returns (cum, delta): cumulative ms per prefix and per-stage deltas
    keyed by stage name ("frame" = the full pipeline).
    """
    import jax

    from tpurast.renderer import render_frame

    stages = STAGES
    cum = {}
    delta = {}
    prev = 0.0
    for s in stages:
        fn = jax.jit(
            functools.partial(render_frame, **renderer._frame_kwargs, stage=s)
        )
        ms = time_frames(fn, renderer.scene, uniforms, frames=frames)
        name = s or "frame"
        cum[name] = round(ms, 3)
        delta[name] = round(ms - prev, 3)
        prev = ms
    return cum, delta
