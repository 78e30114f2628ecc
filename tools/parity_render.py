#!/usr/bin/env python3
"""Render the reference screenshots' recovered camera poses side-by-side.

The reference ships three screenshots (docs/media/*.jpg) and no camera
data; tools/fit_pose.py recovered the poses by silhouette search (IoU
against background / wood-hue masks — see docs/parity/poses.json).
This tool renders each pose at the screenshot's client-area resolution
and writes side-by-side comparison PNGs into docs/parity/.

Known, expected differences on this mount (stated tolerance):
  * the dragon texture and porche.glb are STRIPPED from the reference
    mount (.MISSING_LARGE_BLOBS) — the dragon renders with the fallback
    checker and the Porsche (right half of complex_textured_models) is
    absent, for the reference rebuilt on this mount as well;
  * 2024-08-31_hello_dragon predates the reference's sRGB-correct clear
    color (muted purple vs the magenta every later build clears to);
  * poses are recovered, not exact — geometry lines up to the fitted
    IoU, not pixel-exact framing.

Usage: python tools/parity_render.py [--out docs/parity]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(REPO / "docs" / "parity"))
    ap.add_argument("--data-dir", required=True, help="reference data directory")
    args = ap.parse_args()

    sys.path.insert(0, str(REPO))
    from PIL import Image

    from tpurast import math3d
    from tpurast.assets.gltf import load_glb
    from tpurast.camera import Camera
    from tpurast.config import RendererConfig
    from tpurast.device.scene import build_scene, load_demo_scene
    from tpurast.renderer import Renderer

    poses = json.load(open(REPO / "docs" / "parity" / "poses.json"))
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    up = math3d.WORLD_SPACE.up.vector()
    scenes = {}

    def get_scene(kind):
        if kind not in scenes:
            if kind == "dragon":
                m = load_glb(
                    f"{args.data_dir}/meshes/stanford_dragon.glb",
                    post_transform=math3d.translation(up * -1.0),
                )
                scenes[kind] = build_scene([m], data_dir=args.data_dir)
            else:
                scenes[kind] = load_demo_scene(args.data_dir)
        return scenes[kind]

    for name, spec in poses.items():
        ref_img = np.asarray(Image.open(spec["ref"]).convert("RGB"))[31:]  # drop title bar
        h, w = ref_img.shape[:2]
        r = Renderer(get_scene(spec["scene"]), RendererConfig(width=w, height=h))
        cam = Camera.from_target(
            np.asarray(spec["position"], np.float32),
            np.asarray(spec["target"], np.float32),
        )
        ours = r.render_to_host(cam)[..., :3]
        side = np.concatenate([ref_img, np.full((h, 8, 3), 255, np.uint8), ours], axis=1)
        Image.fromarray(ours).save(out_dir / f"{name}_tpurast.png")
        Image.fromarray(side).save(out_dir / f"{name}_side_by_side.png")
        print(f"{name}: {w}x{h} IoU(fit)={spec['iou']:.3f} -> {name}_side_by_side.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
