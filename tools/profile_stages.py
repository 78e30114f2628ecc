#!/usr/bin/env python3
"""Per-stage device timing for the PRODUCTION frame pipeline.

Thin CLI over tpurast.profiling.stage_sweep (see that module): times
jit-compiled prefixes of render_frame via its `stage=` parameter, so
the deltas between successive prefixes are the per-stage device costs
on the exact production path (corner transform, pair-sort binning,
segment raster, resolve, shading).

Usage: python tools/profile_stages.py [--scene demo] [--width 1920] ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--scene", default="seeded_demo")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--max-anisotropy", type=int, default=None)
    args = ap.parse_args()

    from tpurast.camera import Camera
    from tpurast.config import RendererConfig
    from tpurast.device.scene_cache import load_named_scene
    from tpurast.profiling import stage_sweep
    from tpurast.renderer import Renderer

    scene = load_named_scene(args.scene, args.data_dir, seed=args.seed)
    overrides = {}
    if args.max_anisotropy is not None:
        overrides["max_anisotropy"] = args.max_anisotropy
    cfg = RendererConfig(width=args.width, height=args.height, **overrides)
    r = Renderer(scene, cfg)

    cams = []
    for i in range(64):
        ang = 0.4 + 0.01 * i
        pos = np.array(
            [1.2 * np.sin(ang), 0.75, -1.2 * np.cos(ang)], np.float32
        )
        cams.append(Camera.from_target(pos, [0.0, 0.95, 0.0]))
    uniforms = [r.frame_uniforms(c) for c in cams]

    cum, delta = stage_sweep(r, uniforms, frames=args.frames)
    print(json.dumps({"cum_ms": cum, "stage_ms": delta}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
