#!/usr/bin/env python3
"""GPU smoke test of the frame path: python chip_smoke.py [--cards 4] [--seed N].

Runs in ONE process, phase by phase; a failed phase raises and the
script exits non-zero. There is no CPU fallback: without a GPU it fails.

  1. device  — require JAX platform "gpu"; print the card's name and
               power limit (nvidia-smi).
  2. main    — build the seeded demo scene (device/seeded.py) and run
               Engine at 1920x1080 for 60 frames: zero dropped pairs, a
               frame that is neither empty nor all clear colour. Prints
               compile seconds and the per-frame p50 (block_until_ready).
  3. parity  — at 1080p on the card: raster kernel vs the plain
               formulation (depth + face id), the forward G-buffer path
               vs the deferred per-pixel gather (frame), and the kernel
               frame vs the plain-raster frame (within 1 LSB).
  4. oracle  — the GPU frame vs the plain path run on the in-process CPU
               backend under default_matmul_precision("highest"), at a
               reduced size.
  5. cards   — only with --cards N: the tile-row sharded frame over a
               1-D mesh of N GPUs vs the single-card frame, and nothing
               else.

The last line of stdout is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

WIDTH, HEIGHT = 1920, 1080
ENGINE_FRAMES = 60
TIMED_FRAMES = 30
ORACLE_SIZE = (480, 270)
MAGENTA = np.array([255, 0, 255], np.uint8)

# Tolerances. Triton and XLA may contract multiply-adds into FMAs
# differently and round the depth division differently, so a pixel whose
# centre lies within an ulp of an edge shared by two triangles (or two
# fragments within an ulp of each other in depth) can flip its winner.
# Such flips are counted and bounded; everywhere else the results agree.
MAX_FLIP_FRACTION = 5e-4  # of all pixels: raster winners that differ
DEPTH_RTOL = 1e-5  # depth where both rasters pick the same face
MAX_LSB = 1  # per channel, on pixels whose winners agree


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(n_cards: int):
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu", f"no GPU: JAX platform is {devs[0].platform!r}")
    check(len(devs) >= n_cards, f"need {n_cards} GPUs, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    log(f"card: {smi[0]}")
    log(f"device: {devs[0].device_kind} x{len(devs)} (jax {jax.__version__})")
    return devs


def flip_stats(fid_a, fid_b, depth_a, depth_b):
    """(pixels whose winners differ, max relative depth diff elsewhere)."""
    same = fid_a == fid_b
    flips = int((~same).sum())
    da, db = depth_a[same], depth_b[same]
    rel = np.abs(da - db) / np.maximum(np.abs(db), 1e-30)
    return flips, float(rel.max()) if rel.size else 0.0, same


def lsb_stats(a, b, mask=None):
    """(max per-channel |diff|, pixels > MAX_LSB) over `mask` pixels."""
    d = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(axis=0)  # (H, W)
    if mask is not None:
        d = np.where(mask, d, 0)
    return int(d.max()), int((d > MAX_LSB).sum())


def frame_fn(renderer, **overrides):
    import functools

    import jax

    from tpurast.renderer import render_frame

    return jax.jit(
        functools.partial(render_frame, **dict(renderer._frame_kwargs, **overrides))
    )


def phase_main(scene):
    import jax

    from tpurast.cli import flythrough_cameras
    from tpurast.config import RendererConfig
    from tpurast.engine import Engine

    t0 = time.perf_counter()
    engine = Engine(scene=scene, config=RendererConfig(width=WIDTH, height=HEIGHT))
    jax.block_until_ready(engine.renderer.render(engine.camera))
    compile_s = time.perf_counter() - t0
    last = engine.run(ENGINE_FRAMES)
    check(last is not None and last.shape == (HEIGHT, WIDTH, 4), "no final frame")
    check(engine.dropped_total == 0, f"{engine.dropped_total} pairs dropped")
    covered = (last[..., :3] != MAGENTA).any(-1).mean()
    check(0.05 < covered < 1.0, f"frame covers {covered:.3f} of the screen")
    check(last[..., :3].std() > 1.0, "frame is flat")

    renderer = engine.renderer
    uniforms = [renderer.frame_uniforms(c) for c in flythrough_cameras(TIMED_FRAMES + 2)]
    for u in uniforms[:2]:
        jax.block_until_ready(renderer.render_with_uniforms(*u))
    times = []
    for u in uniforms[2:]:
        t = time.perf_counter()
        jax.block_until_ready(renderer.render_with_uniforms(*u))
        times.append(time.perf_counter() - t)
    p50 = float(np.percentile(np.asarray(times) * 1e3, 50))
    log(
        f"main: Engine {WIDTH}x{HEIGHT}, {ENGINE_FRAMES} frames, dropped 0, "
        f"covered {covered:.3f}; compile+first frame {compile_s:.1f} s; "
        f"frame p50 {p50:.3f} ms over {TIMED_FRAMES} frames (block_until_ready)"
    )
    return renderer, uniforms[2]


def phase_parity(renderer, uniform):
    gk = frame_fn(renderer, output="gbuf")(renderer.scene, *uniform)
    gp = frame_fn(renderer, output="gbuf", raster_impl="plain")(renderer.scene, *uniform)
    fid_k, fid_p = np.asarray(gk["fid"]), np.asarray(gp["fid"])
    flips, rel, same = flip_stats(fid_k, fid_p, np.asarray(gk["depth"]), np.asarray(gp["depth"]))
    limit = int(MAX_FLIP_FRACTION * fid_k.size)
    log(f"parity raster kernel vs plain: {flips} face-id flips (limit {limit}), "
        f"max depth rel diff {rel:.2e} (limit {DEPTH_RTOL:.0e})")
    check(flips <= limit and rel <= DEPTH_RTOL, "raster kernel vs plain out of tolerance")

    fwd = np.asarray(renderer.render_with_uniforms(*uniform)["color"])
    dfr = np.asarray(frame_fn(renderer, shading="deferred")(renderer.scene, *uniform)["color"])
    mx, n_bad = lsb_stats(fwd, dfr)
    log(f"parity resolve G-buffer path vs deferred gather: max {mx} LSB, "
        f"{n_bad} px > {MAX_LSB} LSB")
    check(n_bad == 0, "forward vs deferred frame differs by more than 1 LSB")

    plain = np.asarray(frame_fn(renderer, raster_impl="plain")(renderer.scene, *uniform)["color"])
    h, w = fwd.shape[1:]
    mx, n_bad = lsb_stats(fwd, plain, same[:h, :w])
    log(f"parity frame kernel vs plain raster: max {mx} LSB on agreeing pixels, "
        f"{n_bad} px > {MAX_LSB} LSB")
    check(n_bad == 0, "kernel vs plain-raster frame differs by more than 1 LSB")


def phase_oracle(scene, uniform_cam):
    import jax

    from tpurast.config import RendererConfig
    from tpurast.renderer import Renderer

    w, h = ORACLE_SIZE
    r = Renderer(scene, RendererConfig(width=w, height=h))
    vp, cp = r.frame_uniforms(uniform_cam)
    gpu = frame_fn(r, output="gbuf")(r.scene, vp, cp)
    gpu_color = np.asarray(r.render_with_uniforms(vp, cp)["color"])
    cpu = jax.devices("cpu")[0]
    scene_cpu, vp_c, cp_c = jax.device_put((r.scene, vp, cp), cpu)
    t = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        ref = frame_fn(r, raster_impl="plain")(scene_cpu, vp_c, cp_c)
        ref_g = frame_fn(r, output="gbuf", raster_impl="plain")(scene_cpu, vp_c, cp_c)
        ref_color = np.asarray(ref["color"])
    cpu_s = time.perf_counter() - t
    flips, rel, same = flip_stats(
        np.asarray(gpu["fid"]), np.asarray(ref_g["fid"]),
        np.asarray(gpu["depth"]), np.asarray(ref_g["depth"]),
    )
    limit = int(MAX_FLIP_FRACTION * same.size)
    mx, n_bad = lsb_stats(gpu_color, ref_color, same[:h, :w])
    log(f"oracle GPU vs CPU plain path {w}x{h} ({cpu_s:.1f} s on CPU): "
        f"{flips} face-id flips (limit {limit}), max {mx} LSB on agreeing "
        f"pixels, {n_bad} px > {MAX_LSB} LSB")
    check(flips <= limit and n_bad == 0, "GPU frame vs CPU plain path out of tolerance")


def phase_cards(scene, n_cards: int, cam):
    import jax
    from jax.sharding import Mesh

    from tpurast.config import RendererConfig
    from tpurast.parallel import make_sharded_renderer
    from tpurast.renderer import Renderer

    cfg = RendererConfig(width=WIDTH, height=HEIGHT)
    single = Renderer(scene, cfg)
    vp, cp = single.frame_uniforms(cam)
    ref = np.asarray(single.render_with_uniforms(vp, cp)["color"])
    mesh = Mesh(np.array(jax.devices()[:n_cards]), axis_names=("tiles",))
    fn = make_sharded_renderer(single.scene, cfg, mesh, WIDTH, HEIGHT)
    t = time.perf_counter()
    out = jax.block_until_ready(fn(single.scene, vp, cp))
    compile_s = time.perf_counter() - t
    times = []
    for _ in range(10):
        t = time.perf_counter()
        out = jax.block_until_ready(fn(single.scene, vp, cp))
        times.append(time.perf_counter() - t)
    check(int(out["bin_overflow"]) == 0, "sharded frame dropped pairs")
    mx, n_bad = lsb_stats(np.asarray(out["color"]), ref)
    log(f"cards: {n_cards}-card tile-row sharded {WIDTH}x{HEIGHT} vs single card: "
        f"max {mx} LSB, {n_bad} px > {MAX_LSB} LSB; compile+first {compile_s:.1f} s, "
        f"frame p50 {np.percentile(np.asarray(times) * 1e3, 50):.3f} ms")
    check(n_bad == 0, "sharded frame differs from the single-card frame")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="N > 1 runs only the N-card sharded phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from tpurast import compile_cache

    compile_cache.enable()
    devs = phase_device(args.cards)

    from tpurast.cli import flythrough_cameras
    from tpurast.device.seeded import load_seeded_demo_scene

    t = time.perf_counter()
    scene = load_seeded_demo_scene(args.seed)
    log(f"scene: seeded demo (seed {args.seed}), {scene.n_faces} triangles, "
        f"atlas {scene.atlas.texels.nbytes / 1e9:.2f} GB, built in {time.perf_counter() - t:.1f} s")
    cam = flythrough_cameras(1)[0]
    if args.cards > 1:
        phase_cards(scene, args.cards, cam)
    else:
        renderer, uniform = phase_main(scene)
        phase_parity(renderer, uniform)
        phase_oracle(scene, cam)
    print(json.dumps({
        "ok": True,
        "device": {"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": args.cards},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
