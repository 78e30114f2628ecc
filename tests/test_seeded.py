"""Seeded scenes, the BC7 encoder, device routing and the entry points."""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from tpurast import compile_cache, kernels
from tpurast.assets import bcdec, ktx2, ktx2_write, native
from tpurast.device import seeded

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL_TEXTURE = 64


def _scene_arrays(scene):
    return {
        "corner_world": scene.corner_world,
        "corner_normal": scene.corner_normal,
        "corner_uv": scene.corner_uv,
        "faces": scene.faces,
        "face_tex": scene.face_tex,
        "texels": scene.atlas.texels,
    }


def test_seeded_scene_same_seed_identical():
    a = _scene_arrays(seeded.load_seeded_demo_scene(3, dragon_texture_size=SMALL_TEXTURE))
    b = _scene_arrays(seeded.load_seeded_demo_scene(3, dragon_texture_size=SMALL_TEXTURE))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_seeded_scene_other_seed_differs():
    a = _scene_arrays(seeded.load_seeded_demo_scene(3, dragon_texture_size=SMALL_TEXTURE))
    b = _scene_arrays(seeded.load_seeded_demo_scene(4, dragon_texture_size=SMALL_TEXTURE))
    assert not np.array_equal(a["corner_world"], b["corner_world"])
    assert not np.array_equal(a["texels"], b["texels"])


def test_seeded_scene_shapes():
    scene = seeded.load_seeded_demo_scene(0, dragon_texture_size=SMALL_TEXTURE)
    assert scene.n_faces == 19354  # arena 10 + dragon-class 19,332 + crate 12
    pos, _, _, tris = seeded.dragon_mesh(np.random.default_rng(0))
    assert len(tris) == 19332 and len(pos) == 11340
    extent = pos.max(0) - pos.min(0)
    np.testing.assert_allclose(extent, seeded.DRAGON_EXTENT, rtol=1e-5)
    assert scene.texture_uris == [
        "builtin://fallback-texture", seeded.DRAGON_URI, seeded.CRATE_URI
    ]


def test_seeded_texture_ktx2_full_chain():
    blob = seeded._texture_assets(np.random.default_rng(0), 64)[seeded.DRAGON_URI]
    tex = ktx2.parse_ktx2(blob)
    assert tex.vk_format == ktx2.VK_FORMAT_BC7_SRGB_BLOCK
    assert tex.supercompression == ktx2.SUPERCOMPRESSION_NONE
    assert [lvl.width for lvl in tex.levels] == [64, 32, 16, 8, 4, 2, 1]


@pytest.mark.parametrize("shape", [(64, 64), (20, 36), (1, 1)])
def test_bc7_mode6_roundtrip_both_decoders(shape):
    rng = np.random.default_rng(shape[0])
    h, w = shape
    # Smooth content round-trips near-losslessly; noise exercises every
    # index and p-bit path.
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([xx * 3, yy * 3, xx + yy, 255 - 2 * xx], -1)
    noise = rng.integers(0, 256, (h, w, 4))
    for img, tol in ((smooth, 8), (noise, 255)):
        img = img.astype(np.uint8)
        blocks = np.frombuffer(ktx2_write.encode_bc7_mode6(img), np.uint8)
        blocks = blocks.reshape(-1, 16)
        assert ((blocks[:, 0] & 0x7F) == 0x40).all()  # mode 6 everywhere
        ref = bcdec.decode_bc7(blocks)
        if native.available():
            np.testing.assert_array_equal(native.decode_bc7(blocks), ref)
        out = bcdec.assemble_blocks(ref, -(-w // 4), -(-h // 4), w, h)
        assert np.abs(out.astype(int) - img).max() <= tol


@pytest.mark.parametrize("value", [0.0, 0.25, 1.0, 7.5, 65504.0])
def test_bc6h_mode3_roundtrip_both_decoders(value):
    from tpurast.assets import bc6h

    flat = np.full((8, 8, 3), value, np.float32)
    ramp = (value + 1.0) * np.linspace(1.0, 1.5, 64 * 3, dtype=np.float32).reshape(8, 8, 3)
    for img, rtol in ((flat, 4e-3), (ramp, 0.1)):
        img = np.minimum(img, 65504.0)
        blocks = np.frombuffer(ktx2_write.encode_bc6h_mode3(img), np.uint8).reshape(-1, 16)
        assert ((blocks[:, 0] & 0x1F) == 0x03).all()
        ref = bc6h.decode_bc6h(blocks)
        if native.available():
            np.testing.assert_array_equal(native.decode_bc6h(blocks), ref)
        out = bcdec.assemble_blocks(ref, 2, 2, 8, 8)
        np.testing.assert_allclose(out, img, rtol=rtol, atol=1e-3)


def test_seeded_hdr_scene_shapes():
    scene = seeded.load_seeded_hdr_scene(0)
    assert scene.n_faces == 2 + 12 + 12
    assert scene.atlas.max_value() > 1000.0  # true HDR radiance survives decode
    assert [int(n) for n in scene.atlas.n_mips[1:]] == [9, 1, 8]


@pytest.mark.parametrize(
    "backend,expected",
    [("cpu", True), ("gpu", False), ("rocm", RuntimeError), ("METAL", RuntimeError)],
)
def test_interpret_mode_routing(monkeypatch, backend, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if expected is RuntimeError:
        with pytest.raises(RuntimeError):
            kernels.interpret_mode()
    else:
        assert kernels.interpret_mode() is expected


def test_compile_cache_default_dir(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert compile_cache.cache_dir() == str(REPO / ".jax_cache")
    prev = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable() == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_env_dir(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    prev = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable() == str(tmp_path)
        # JAX reads the variable itself; the code sets no other directory.
        assert jax.config.jax_compilation_cache_dir == prev
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_engine_frame_without_pillow_or_zstandard(monkeypatch):
    from tpurast.config import RendererConfig
    from tpurast.engine import Engine

    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "zstandard", None)
    scene = seeded.load_seeded_demo_scene(1, dragon_texture_size=SMALL_TEXTURE)
    eng = Engine(scene=scene, config=RendererConfig(width=64, height=32))
    img = eng.run(2)
    assert img.shape == (32, 64, 4)
    # The overlay box darkens the top-left corner over the magenta sky.
    assert img[5, 5, 0] < 255


@pytest.mark.gpu
def test_raster_kernel_matches_plain_on_gpu(gpu, demo_scene):
    """On the card: the compiled Triton kernel vs the plain formulation."""
    from tpurast.camera import Camera
    from tpurast.config import RendererConfig
    from tpurast.renderer import Renderer

    r = Renderer(demo_scene, RendererConfig(width=640, height=360))
    cam = Camera.from_target([1.2 * np.sin(0.4), 0.75, -1.2 * np.cos(0.4)], [0, 0.95, 0])
    a = r.render_to_host(cam).astype(int)
    import functools

    from tpurast.present import interleave
    from tpurast.renderer import render_frame

    plain = jax.jit(functools.partial(render_frame, **dict(r._frame_kwargs, raster_impl="plain")))
    b = interleave(np.asarray(plain(r.scene, *r.frame_uniforms(cam))["color"])).astype(int)
    assert (np.abs(a - b).max(-1) > 1).mean() < 5e-4
