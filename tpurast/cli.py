"""tpurast-bench CLI: the benchmark entry point (see repo bench.py).

Prints ONE JSON line with fps/p50/Mtris plus the honest present-loop
(host-visible) frame rate and the dropped-pair counter. Every frame of
the timed loop ends in block_until_ready. `--stages` adds a per-stage
device-time decomposition (stage_ms) to the line; `--all` runs every
seeded benchmark config and prints one line each (see BASELINE.md):

  #1/#5 seeded_demo @1080p (+ flythrough present loop, part of every run)
  #4     seeded_dragons64 @4K (64x instanced tiled binning)

The reference-asset scenes (demo, porsche_class, hdr, dragons64) run
with --scene NAME --data-dir DIR. Timings are taken only on a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

from tpurast.device.scene_cache import DATA_SCENES, SEEDED_SCENES

#: BASELINE benchmark configs for --all: (extra argv, config label).
ALL_CONFIGS = [
    (["--scene", "seeded_demo", "--width", "1920", "--height", "1080"], "demo_1080p"),
    (
        ["--scene", "seeded_dragons64", "--width", "3840", "--height", "2160"],
        "dragons64_4k",
    ),
]


def flythrough_cameras(n: int):
    """The benchmark's camera track: a slow orbit near the crate/dragon
    like the reference screenshots."""
    from tpurast.camera import Camera

    cams = []
    for i in range(n):
        ang = 0.4 + 0.01 * i
        pos = np.array([1.2 * np.sin(ang), 0.75, -1.2 * np.cos(ang)], dtype=np.float32)
        cams.append(Camera.from_target(pos, [0.0, 0.95, 0.0]))
    return cams


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument(
        "--data-dir", default=None,
        help="reference data directory (only the non-seeded scenes need it)",
    )
    ap.add_argument("--seed", type=int, default=0, help="seed of the seeded scenes")
    ap.add_argument("--texture-dtype", default=None)
    ap.add_argument("--tile-h", type=int, default=None)
    ap.add_argument("--tile-w", type=int, default=None)
    # Runtime toggles, the analog of the reference's ImGui settings
    # (VSync checkbox src/Renderer.zig:970-973) plus every pipeline mode.
    ap.add_argument("--max-anisotropy", type=int, default=None)
    ap.add_argument(
        "--vsync", action="store_true",
        help="cap the present loop at 60 Hz (Engine.vsync analog)"
    )
    ap.add_argument("--shading", default=None, choices=["forward", "deferred"])
    ap.add_argument("--binning", default=None, choices=["auto", "pairs", "scan"])
    ap.add_argument(
        "--scene",
        default="seeded_demo",
        choices=[*SEEDED_SCENES, *DATA_SCENES],
        help="seeded_demo = the Engine.init scene's shapes from --seed; "
        "*dragons64 = BASELINE config #4",
    )
    ap.add_argument("--save", default=None, help="save last frame PNG here")
    ap.add_argument(
        "--skip-parity-gate", action="store_true",
        help="skip the raster kernel vs plain-formulation frame check",
    )
    ap.add_argument(
        "--stages", action="store_true",
        help="add per-stage device timing (stage_ms) to the JSON line",
    )
    ap.add_argument(
        "--all", action="store_true",
        help="run every BASELINE benchmark config (one JSON line each)",
    )
    return ap


def _run_all(argv_rest: list[str]) -> int:
    """Run each BASELINE config in its own subprocess, one at a time
    (fresh device memory per scene; the parent never initialises JAX, so
    only one process holds the card) and forward the JSON lines."""
    rc_all = 0
    for extra, label in ALL_CONFIGS:
        cmd = [sys.executable, "-m", "tpurast.cli", *extra, *argv_rest]
        print(f"# config {label}: {' '.join(cmd[2:])}", file=sys.stderr)
        rc = subprocess.call(cmd)
        rc_all = rc_all or rc
    return rc_all


def main() -> int:
    ap = _build_parser()
    args = ap.parse_args()
    if args.all:
        rest = [a for a in sys.argv[1:] if a != "--all"]
        drop_next = False
        filtered = []
        for a in rest:
            if drop_next:
                drop_next = False
                continue
            if a in ("--scene", "--width", "--height"):
                drop_next = True
                continue
            if a.startswith(("--scene=", "--width=", "--height=")):
                continue
            filtered.append(a)
        return _run_all(filtered)

    import jax

    from tpurast import compile_cache
    from tpurast.config import RendererConfig
    from tpurast.device.scene_cache import load_named_scene
    from tpurast.present import Presenter
    from tpurast.renderer import Renderer

    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"tpurast-bench: no GPU (found {dev.platform}); timings are taken "
              "only on a GPU", file=sys.stderr)
        return 2

    scene = load_named_scene(args.scene, args.data_dir, seed=args.seed)
    overrides = {}
    if args.texture_dtype:
        overrides["texture_dtype"] = args.texture_dtype
    if args.tile_h:
        overrides["tile_h"] = args.tile_h
    if args.tile_w:
        overrides["tile_w"] = args.tile_w
    if args.max_anisotropy is not None:
        overrides["max_anisotropy"] = args.max_anisotropy
    if args.shading:
        overrides["shading"] = args.shading
    if args.binning:
        overrides["binning"] = args.binning
    cfg = RendererConfig(width=args.width, height=args.height, **overrides)
    renderer = Renderer(scene, cfg)

    # Flythrough cameras (precomputed uniforms so the loop measures only
    # render + readback): slow orbit near the crate/dragon like the
    # reference screenshots.
    cams = flythrough_cameras(args.frames + args.warmup)
    uniforms = [renderer.frame_uniforms(c) for c in cams]

    # Correctness gate: the frame through the raster kernel against the
    # same frame through the plain raster formulation, at the first
    # camera. >1 LSB anywhere withholds the perf numbers.
    parity_max_lsb = None
    if not args.skip_parity_gate:
        parity_max_lsb = raster_parity_lsb(renderer, uniforms[0])
        if parity_max_lsb > 1:
            print(json.dumps({
                "metric": "parity_gate_failed",
                "value": parity_max_lsb,
                "unit": "max_lsb_diff",
                "note": "raster kernel vs plain formulation diverged; "
                "perf numbers withheld",
            }))
            return 1

    # Warmup / compile.
    t_compile = time.perf_counter()
    for u in uniforms[: args.warmup]:
        jax.block_until_ready(renderer.render_with_uniforms(*u))
    compile_s = time.perf_counter() - t_compile

    # Device frame time: every frame ends in block_until_ready.
    t0 = time.perf_counter()
    times = []
    dropped_total = 0
    batch = uniforms[args.warmup :]
    for u in batch:
        prev = time.perf_counter()
        frame = jax.block_until_ready(renderer.render_with_uniforms(*u))
        times.append(time.perf_counter() - prev)
        # Honest-overflow accounting: an undersized bin capacity would
        # silently drop triangles AND flatter the benchmark.
        dropped_total += int(np.asarray(frame["bin_overflow"]))
    wall = time.perf_counter() - t0

    # Config #5 (60 Hz flythrough with device->host readback), measured
    # HONESTLY: the timed loop includes the double-buffered full-frame
    # readback, so present_fps is the host-visible frame rate.
    presenter = Presenter()
    last_host = None
    n_present = min(len(batch), 48)
    tp0 = time.perf_counter()
    for u in batch[:n_present]:
        t_frame = time.perf_counter()
        img = presenter.present(renderer.render_with_uniforms(*u)["color"])
        if args.vsync:  # Engine.vsync analog: 60 Hz frame cap
            time.sleep(max(0.0, 1.0 / 60.0 - (time.perf_counter() - t_frame)))
        if img is not None:
            last_host = img
    tail = presenter.flush()
    present_wall = time.perf_counter() - tp0
    present_ms = present_wall / max(n_present, 1) * 1e3
    if tail is not None:
        last_host = tail

    stage_ms = None
    if args.stages:
        from tpurast.profiling import stage_sweep

        _, stage_ms = stage_sweep(renderer, uniforms, frames=32)

    times_ms = np.asarray(times) * 1e3
    p50 = float(np.percentile(times_ms, 50))
    fps = 1000.0 / p50
    tris = scene.n_faces
    mtris_per_s = tris * fps / 1e6

    if args.save and last_host is not None:
        from PIL import Image

        Image.fromarray(last_host[..., :3]).save(args.save)

    baseline_fps = 1000.0 / 1.33230  # reference overlay frametime
    result = {
        "metric": f"fps_{args.width}x{args.height}_{args.scene}_scene",
        "value": round(fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(fps / baseline_fps, 4),
        "p50_frame_ms": round(p50, 4),
        "mean_frame_ms": round(float(times_ms.mean()), 4),
        "mtris_per_sec": round(mtris_per_s, 2),
        "triangles": tris,
        "frames": args.frames,
        "wall_s": round(wall, 2),
        "compile_s": round(compile_s, 2),
        "dropped_pairs": dropped_total,
        "parity_max_lsb": parity_max_lsb,
        "stage_ms": stage_ms,
        "present_ms_per_frame": round(present_ms, 4),
        "present_fps": round(1000.0 / present_ms, 2) if present_ms > 0 else None,
        "backend": jax.default_backend(),
        "device": str(dev),
        "device_kind": dev.device_kind,
        "device_count": jax.device_count(),
        "note": (
            "baseline=1.3323ms @~720p: the reference's own overlay frametime "
            "on its unstated GPU. present_fps includes the full-frame "
            "device->host readback."
        ),
    }
    print(json.dumps(result))
    return 0


def raster_parity_lsb(renderer, uniform) -> int:
    """Max per-channel |LSB| difference between `renderer`'s frame and the
    same frame rasterized by the plain formulation (raster.RASTERIZERS)."""
    import functools

    import jax

    from tpurast.renderer import render_frame

    plain = jax.jit(
        functools.partial(render_frame, **dict(renderer._frame_kwargs, raster_impl="plain"))
    )
    a = np.asarray(renderer.render_with_uniforms(*uniform)["color"]).astype(np.int32)
    b = np.asarray(plain(renderer.scene, *uniform)["color"]).astype(np.int32)
    return int(np.abs(a - b).max())


if __name__ == "__main__":
    sys.exit(main())
