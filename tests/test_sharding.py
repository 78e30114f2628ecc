"""Multi-device (virtual 8-CPU mesh) tile-sharded rendering tests."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from tpurast.camera import Camera
from tpurast.config import RendererConfig
from tpurast.parallel import make_sharded_renderer
from tpurast.renderer import Renderer

# Long CPU-interpret renders: excluded from the fast subset
# (`pytest -m 'not slow'`, see README testing section).
pytestmark = pytest.mark.slow


def test_eight_device_mesh_available():
    assert len(jax.devices()) == 8  # conftest forces the virtual CPU mesh


def test_sharded_matches_single_device(demo_scene):
    cfg = RendererConfig(width=160, height=96, segment_headroom=256)
    cam = Camera.from_target([0, 0, -2.5], [0, 0, 1])

    single = Renderer(demo_scene, cfg)
    ref = single.render_to_host(cam)

    mesh = Mesh(np.array(jax.devices()).reshape(8), axis_names=("tiles",))
    scene_dev = demo_scene.device()
    fn = make_sharded_renderer(scene_dev, cfg, mesh, 160, 96)
    view_proj, cam_pos = single.frame_uniforms(cam)
    out = fn(scene_dev, view_proj, cam_pos)
    color = np.moveaxis(np.asarray(out["color"]), 0, -1)  # planar -> HWC
    assert int(out["bin_overflow"]) == 0
    assert color.shape == ref.shape

    # Slabs render in GLOBAL pixel coordinates through the SAME
    # render_frame as the single-card path, so the sharded frame is
    # bit-identical — no reassociation tolerance.
    np.testing.assert_array_equal(color, ref)


def test_sharded_depth_matches_single_device(demo_scene):
    # Depth slabs must be bit-identical to the single-chip depth image —
    # in particular continuous across slab boundaries (no seams).
    cfg = RendererConfig(width=160, height=128, tile_h=8, segment_headroom=256)
    cam = Camera.from_target([0, 0, -2.5], [0, 0, 1])
    mesh = Mesh(np.array(jax.devices()).reshape(8), axis_names=("tiles",))
    scene_dev = demo_scene.device()
    fn = make_sharded_renderer(scene_dev, cfg, mesh, 160, 128)
    single = Renderer(demo_scene, cfg)
    view_proj, cam_pos = single.frame_uniforms(cam)
    depth = np.asarray(fn(scene_dev, view_proj, cam_pos)["depth"])
    ref_depth = np.asarray(single.render(cam)["depth"])
    np.testing.assert_array_equal(depth, ref_depth)


def test_sharded_deferred_shading_matches(demo_scene):
    # The sharded path is shading-mode agnostic (no pipeline fork):
    # deferred must also be bit-identical to single-chip deferred.
    cfg = RendererConfig(width=160, height=96, segment_headroom=256, shading="deferred")
    cam = Camera.from_target([0, 0, -2.5], [0, 0, 1])
    single = Renderer(demo_scene, cfg)
    ref = single.render_to_host(cam)
    mesh = Mesh(np.array(jax.devices()).reshape(8), axis_names=("tiles",))
    scene_dev = demo_scene.device()
    fn = make_sharded_renderer(scene_dev, cfg, mesh, 160, 96)
    view_proj, cam_pos = single.frame_uniforms(cam)
    color = np.moveaxis(np.asarray(fn(scene_dev, view_proj, cam_pos)["color"]), 0, -1)
    np.testing.assert_array_equal(color, ref)
