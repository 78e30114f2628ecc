"""End-to-end pipeline tests: seeded demo scene -> framebuffer (CPU, interpret)."""

import numpy as np
import pytest

from tpurast.camera import Camera, MoveDirection
from tpurast.config import RendererConfig
from tpurast.engine import Engine
from tpurast.renderer import Renderer

MAGENTA = np.array([255, 0, 255], dtype=np.uint8)


@pytest.fixture(scope="module")
def renderer(demo_scene):
    return Renderer(demo_scene, RendererConfig(width=160, height=96, segment_headroom=192))


def demo_camera():
    return Camera.from_target([0, 0, -2.5], [0, 0, 1])


def test_demo_scene_composition(demo_scene):
    # arena + dragon-class mesh + crate (the demo without the Porsche).
    assert demo_scene.n_faces == 19354
    assert demo_scene.texture_uris[0] == "builtin://fallback-texture"
    assert any("crate" in u for u in demo_scene.texture_uris)


def test_render_background_is_clear_color(renderer):
    out = renderer.render_to_host(demo_camera())
    assert out.shape == (96, 160, 4)
    assert out.dtype == np.uint8
    # Top rows are sky: exact magenta clear (1,0,1,1) in sRGB u8.
    np.testing.assert_array_equal(
        out[:10, :, :3], np.broadcast_to(MAGENTA, (10, 160, 3))
    )
    assert (out[..., 3] == 255).all()


def test_render_covers_scene(renderer):
    from tpurast.present import interleave

    res = renderer.render(demo_camera())
    out = interleave(np.asarray(res["color"]))
    covered = (out[..., :3] != MAGENTA).any(-1)
    assert 0.3 < covered.mean() < 0.9  # floor+wall fill the lower half
    assert int(res["bin_overflow"]) == 0
    depth = np.asarray(res["depth"])
    assert (depth[covered] > 0).all()
    assert (depth[~covered] == 0).all()


def test_render_deterministic(renderer):
    a = renderer.render_to_host(demo_camera())
    b = renderer.render_to_host(demo_camera())
    np.testing.assert_array_equal(a, b)


def test_depth_ordering_crate_in_front_of_floor(renderer):
    # The crate sits closer to the camera than the arena back wall; pixels
    # in the crate's screen area must have larger reversed-Z depth than
    # wall pixels.
    res = renderer.render(demo_camera())
    depth = np.asarray(res["depth"])
    # crate front ~ screen center-bottom; far wall ~ just below the
    # horizon, left of center.
    crate_d = depth[85, 80]
    wall_d = depth[56, 60]
    assert crate_d > wall_d > 0


@pytest.mark.slow
def test_resize_recreates_target(demo_scene):
    r = Renderer(demo_scene, RendererConfig(width=96, height=64, segment_headroom=192))
    out = r.render_to_host(demo_camera())
    assert out.shape == (64, 96, 4)
    r.recreate_swapchain(128, 72)
    out2 = r.render_to_host(demo_camera())
    assert out2.shape == (72, 128, 4)


@pytest.mark.slow
def test_srgb8_atlas_matches_float(demo_scene):
    # srgb8 texel storage (u8 sRGB rows + exact in-sampler EOTF) must
    # reproduce the float path within 1 output LSB: the BC7 sources ARE
    # u8 sRGB, so the only difference is f16 quantization on the float
    # side vs exact u8 round-trip on the srgb8 side.
    cfgs = dict(width=96, height=64, segment_headroom=192)
    cam = demo_camera()
    a = Renderer(
        demo_scene, RendererConfig(texture_dtype="float32", **cfgs)
    ).render_to_host(cam)
    b = Renderer(
        demo_scene, RendererConfig(texture_dtype="srgb8", **cfgs)
    ).render_to_host(cam)
    diff = np.abs(a.astype(int) - b.astype(int))
    assert diff.max() <= 1, f"srgb8 vs float32 max diff {diff.max()}"


@pytest.mark.slow
def test_blend_state_opaque_content_invariant(demo_scene):
    # The reference's blend state (srcAlpha/1-srcAlpha + add, alpha
    # zero/one; src/Renderer.zig:447-458) with the shader's constant
    # output alpha 1.0 (basic.frag:38) must produce the exact opaque
    # image — the blend equation exists as pipeline state, the content
    # is opaque.
    cfgs = dict(width=96, height=64, segment_headroom=192)
    cam = demo_camera()
    a = Renderer(demo_scene, RendererConfig(blend="alpha", **cfgs)).render_to_host(cam)
    b = Renderer(demo_scene, RendererConfig(blend="opaque", **cfgs)).render_to_host(cam)
    np.testing.assert_array_equal(a, b)


def test_blend_planes_translucent():
    # Direct check of the blend equation with a non-1 source alpha.
    import jax.numpy as jnp

    from tpurast.kernels.shade import blend_planes

    rgb = [jnp.full((2, 2), 0.8), jnp.full((2, 2), 0.4), jnp.full((2, 2), 0.0)]
    mask = jnp.array([[True, False], [True, True]])
    out = blend_planes(rgb, jnp.float32(0.25), mask, (1.0, 0.0, 1.0, 1.0), "alpha")
    out = np.asarray(jnp.stack(out))
    # covered: src*0.25 + clear*0.75 ; uncovered: clear
    np.testing.assert_allclose(out[0][0, 0], 0.8 * 0.25 + 1.0 * 0.75, rtol=1e-6)
    np.testing.assert_allclose(out[2][0, 0], 0.0 * 0.25 + 1.0 * 0.75, rtol=1e-6)
    assert out[0][0, 1] == 1.0 and out[2][0, 1] == 1.0
    # alpha target: srcFactor ZERO, dstFactor ONE -> clear alpha kept.
    assert (out[3] == 1.0).all()


@pytest.mark.slow
def test_zero_extent_defers_recreation(demo_scene):
    # Minimized-window semantics (src/Renderer.zig:631-636): a zero
    # extent must not produce a zero-tile target; recreation is deferred
    # and rendering continues at the previous size until a usable extent
    # arrives.
    r = Renderer(demo_scene, RendererConfig(width=96, height=64, segment_headroom=192))
    r.recreate_swapchain(0, 0)
    out = r.render_to_host(demo_camera())
    assert out.shape == (64, 96, 4)  # old target still in use
    r.recreate_swapchain(128, 72)  # window restored
    assert r.render_to_host(demo_camera()).shape == (72, 128, 4)


def test_engine_loop_double_buffered(demo_scene):
    eng = Engine(scene=demo_scene, config=RendererConfig(width=96, height=64, segment_headroom=192))
    first = eng.tick()
    assert first is None  # frame 0 still in flight
    second = eng.tick(move=MoveDirection(forward=True))
    assert second is not None and second.shape == (64, 96, 4)
    final = eng.run(3)
    assert final.shape == (64, 96, 4)
    assert eng.stats.p50_ms > 0
    # Moving forward must change the camera position.
    assert eng.camera.position[2] > -2.5


def test_specular_highlight_present(demo_scene):
    # The crate albedo has a specular mask; with the light from (1,-1,1)
    # some crate pixels should be brighter than the pure-diffuse bound
    # (ambient+diffuse)*albedo <= (0.1+1)*lcol*1; specular adds beyond
    # diffuse-only. Weak but useful signal: max luminance on covered,
    # non-fallback pixels exceeds diffuse-only ceiling of dark wood.
    r = Renderer(demo_scene, RendererConfig(width=256, height=256, segment_headroom=192))
    cam = Camera.from_target([0.0, 1.0, -1.2], [0, 1.2, 0])  # look at crate
    out = r.render_to_host(cam).astype(np.float32)
    assert out[..., :3].max() > 60  # highlights clearly above base albedo


def test_hdr_scene_renders():
    # BASELINE config #3: BC6H HDR base color + generated BC4u monochrome
    # map, full mip chain trilinear (seeded: generated BC6H crates).
    from tpurast.device.seeded import load_seeded_hdr_scene

    scene = load_seeded_hdr_scene(0)
    assert "mem://hdr_bc6u.ktx2" in scene.texture_uris
    assert "mem://bc4_stripes.ktx2" in scene.texture_uris
    r = Renderer(scene, RendererConfig(width=128, height=96, segment_headroom=64),
                 output="linear_f32")
    cam = Camera.from_target([0.6, 0.4, -2.0], [0.3, 1.5, 0.0])
    res = r.render(cam)
    lin = np.moveaxis(np.asarray(res["color"]), 0, -1)  # planar -> (H, W, 4)
    assert int(res["bin_overflow"]) == 0
    # True HDR radiance survives to the linear framebuffer (>1.0).
    assert lin[..., :3].max() > 10.0
    covered = (lin[..., :3] != np.asarray([1.0, 0.0, 1.0], np.float32)).any(-1)
    assert covered.mean() > 0.4  # floor + two crates


def test_instanced_dragons_scene():
    from conftest import TEST_TEXTURE_SIZE

    from tpurast.device.seeded import load_seeded_dragons

    scene = load_seeded_dragons(0, 4, dragon_texture_size=TEST_TEXTURE_SIZE)
    assert scene.n_faces == 4 * 19332
    r = Renderer(scene, RendererConfig(width=128, height=96, segment_headroom=1024))
    cam = Camera.from_target([0.0, 0.5, -1.0], [0.0, 0.95, 0.0])
    out = r.render_to_host(cam)
    covered = (out[..., :3] != MAGENTA).any(-1)
    assert covered.sum() > 50


def test_forward_shading_matches_deferred(demo_scene):
    # The forward path (kernels/resolve.py G-buffer + shade_gbuffer) must
    # reproduce the deferred fat-gather path exactly: same interpolation
    # formulas, same attribute values, same lighting op order.
    cfgs = dict(width=160, height=96, segment_headroom=192)
    cam = demo_camera()
    fwd = Renderer(demo_scene, RendererConfig(shading="forward", **cfgs))
    dfr = Renderer(demo_scene, RendererConfig(shading="deferred", **cfgs))
    a = fwd.render(cam)
    b = dfr.render(cam)
    np.testing.assert_array_equal(np.asarray(a["depth"]), np.asarray(b["depth"]))
    np.testing.assert_array_equal(np.asarray(a["color"]), np.asarray(b["color"]))


def test_forward_matches_deferred_anisotropic(demo_scene):
    # The exact-equality invariant is between the two SHADING
    # architectures sharing one sampling formula.
    cfgs = dict(width=128, height=96, segment_headroom=192, max_anisotropy=4)
    cam = Camera.from_target([0.0, 1.3, -1.5], [0.0, 1.6, 1.0])  # grazing floor
    fwd = Renderer(demo_scene, RendererConfig(shading="forward", **cfgs))
    dfr = Renderer(demo_scene, RendererConfig(shading="deferred", **cfgs))
    np.testing.assert_array_equal(fwd.render_to_host(cam), dfr.render_to_host(cam))
