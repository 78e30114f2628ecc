#!/usr/bin/env python3
"""Raster kernel vs plain formulation, end to end, on the GPU.

For each cell (seeded demo at 1920x1080, seeded dragon-class mesh x64 at
3840x2160) this renders the benchmark flythrough with the frame function
built two ways — raster through the Pallas kernel, raster through the
plain jax.numpy formulation — and times them in turns (kernel, plain,
plain, kernel; every frame ends in block_until_ready). It also times the
pipeline prefixes of the kernel path (profiling.stage_sweep) and the
plain raster prefix, so the raster, resolve and shading (texture gather
+ lighting) shares of the frame come out of the same run.

Prints one JSON line per cell (with the card's name and power limit);
--out also writes them to a file. GPU only.

Usage: python tools/raster_ab.py [--frames 20] [--cells demo,dragons64] [--out FILE]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

CELLS = {
    "demo": ("seeded_demo", 1920, 1080),
    "dragons64": ("seeded_dragons64", 3840, 2160),
}


def run_cell(name: str, frames: int, card: str) -> dict:
    import jax

    from tpurast.cli import flythrough_cameras
    from tpurast.config import RendererConfig
    from tpurast.device import seeded
    from tpurast.profiling import stage_sweep, time_frames
    from tpurast.renderer import Renderer, render_frame

    scene_name, w, h = CELLS[name]
    t = time.perf_counter()
    scene = (
        seeded.load_seeded_demo_scene(0)
        if scene_name == "seeded_demo"
        else seeded.load_seeded_dragons(0, 64)
    )
    build_s = time.perf_counter() - t
    r = Renderer(scene, RendererConfig(width=w, height=h))
    uniforms = [r.frame_uniforms(c) for c in flythrough_cameras(frames + 4)]
    fns = {
        "kernel": r._frame_fn,
        "plain": jax.jit(
            functools.partial(render_frame, **dict(r._frame_kwargs, raster_impl="plain"))
        ),
    }
    compile_s = {}
    dropped = {}
    for k, fn in fns.items():
        t = time.perf_counter()
        out = jax.block_until_ready(fn(r.scene, *uniforms[0]))
        compile_s[k] = round(time.perf_counter() - t, 2)
        dropped[k] = int(out["bin_overflow"])
        for u in uniforms[1:4]:
            jax.block_until_ready(fn(r.scene, *u))
    timed = uniforms[4:]
    runs = {"kernel": [], "plain": []}
    for k in ("kernel", "plain", "plain", "kernel"):
        runs[k].append(time_frames(fns[k], r.scene, timed, warmup=0, frames=len(timed)))
    _, stage_ms = stage_sweep(r, uniforms, frames=frames)
    plain_raster = jax.jit(
        functools.partial(
            render_frame, **dict(r._frame_kwargs, raster_impl="plain", stage="raster")
        )
    )
    plain_raster_cum = time_frames(plain_raster, r.scene, uniforms, frames=frames)
    return {
        "cell": name,
        "scene": scene_name,
        "width": w,
        "height": h,
        "triangles": scene.n_faces,
        "card": card,
        "device_kind": jax.devices()[0].device_kind,
        "frame_p50_ms": {k: [round(v, 4) for v in vs] for k, vs in runs.items()},
        "kernel_stage_ms": stage_ms,
        "plain_raster_prefix_ms": round(plain_raster_cum, 4),
        "compile_s": compile_s,
        "dropped_pairs": dropped,
        "scene_build_s": round(build_s, 1),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args()

    import jax

    from tpurast import compile_cache

    compile_cache.enable()
    if jax.devices()[0].platform != "gpu":
        print("raster_ab: needs a GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    lines = []
    for name in args.cells.split(","):
        res = run_cell(name, args.frames, card)
        print(json.dumps(res), flush=True)
        lines.append(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        pathlib.Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
