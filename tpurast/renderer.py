"""The Renderer: device/pipeline lifecycle + per-frame orchestration.

Equivalent of src/Renderer.zig (init :162, renderFrame :950,
recreateSwapchain :631): owns the jit-compiled frame function, the
device-resident scene, and the render-target configuration. A "frame" is one
jit call:

  vertex transform -> triangle setup/cull -> tile binning
  -> visibility raster (Pallas kernel) -> attribute resolve
  -> texture gather + lighting -> sRGB encode

All stages are traced into a single XLA program, so per-frame host work is
one dispatch + the 4x4 view matrix upload (the reference's per-frame
traffic is likewise just the 144-byte frame UBO, SURVEY §3.2).
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np

from tpurast import math3d
from tpurast.camera import Camera
from tpurast.config import RendererConfig
from tpurast.device.scene import DeviceScene
from tpurast.kernels import geometry, present, raster, resolve, shade

log = logging.getLogger("tpurast.renderer")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _stage_probe(*arrs):
    """Tiny reduction over stage outputs: a `stage=` prefix frame
    returns this instead of the framebuffer, so XLA compiles (and the
    profiler times) exactly the work up to that stage — on the
    PRODUCTION path, with nothing downstream. The full-array sums cost
    one device-memory read of the stage output."""
    s = jnp.float32(0)
    for a in arrs:
        s = s + jnp.sum(a.astype(jnp.float32))
    return {"stage_probe": s}


def sizing(cfg: RendererConfig, f_pad: int, binning: str) -> tuple[int, int]:
    """(bin_capacity, segment_headroom) for a scene of f_pad faces.

    Pair-buffer capacity (scan path): total (tile, face) pairs per frame.
    Typical scenes produce < 2 pairs/face; 4x is generous headroom and
    truncation is counted in bin_overflow. The sort path sizes itself.

    Segment headroom is sized to the TYPICAL need (pairs ~ faces/2 for
    tile-sized triangles -> extra segments ~ pairs/CHUNK) rather than the
    adversarial bound, because the segment-ordered setup rows scale with
    it; a frame that exceeds it drops triangles VISIBLY (dropped counter
    -> Engine warning + bench "dropped_pairs"), and
    RendererConfig.segment_headroom raises the cap.
    """
    cap = cfg.bin_capacity if cfg.bin_capacity is not None else max(4 * f_pad, 16384)
    cap = _round_up(max(cap, 128), 128)
    if binning == "pairs":
        headroom = min(max(256, f_pad // 256), cfg.segment_headroom)
    else:
        headroom = min(cfg.segment_headroom, max(512, f_pad // 32))
    return cap, headroom


def render_frame(
    scene,
    view_proj,
    camera_position,
    *,
    width: int,
    height: int,
    tile_h: int,
    tile_w: int,
    tiles_x: int,
    tiles_y: int,
    bin_capacity: int,
    segment_headroom: int,
    clear_depth: float,
    clear_color,
    light_direction,
    light_color,
    ambient_amount: float,
    specular_power: float,
    max_anisotropy: int = 1,
    blend: str = "alpha",
    texture_format: str = "float",
    output: str = "srgb_u8",
    shading: str = "forward",
    binning: str = "scan",
    raster_impl: str = "kernel",
    tile_row_offset=None,
    crop_height: int | None = None,
    stage: str | None = None,
):
    """Pure frame function (jit-traced once per config/scene shape).

    shading="forward": the resolve pass gathers the winning face's
    attributes per pixel into a G-buffer (kernels/resolve.py), then
    shade.shade_gbuffer samples + lights. shading="deferred": the
    per-pixel fat-gather path — same results, kept for verification.
    raster_impl: "kernel" (kernels/raster.rasterize_tiles) or "plain"
    (its jax.numpy reference formulation).

    The SHARDED path (tpurast/parallel.py) calls this same function per
    device with tile_row_offset = its slab's first global tile row and
    tiles_y = the slab's tile rows: binning, raster, resolve, and shade
    all evaluate in GLOBAL pixel coordinates, so each slab's output is
    bit-identical to the corresponding rows of a single-chip frame.
    crop_height (static, default height) trims the slab output.

    Returns dict with framebuffer plus profiling scalars (overflow count).
    """
    if tile_row_offset is None:
        ty_base = 0
        y_offset_px = 0
    else:
        ty_base = tile_row_offset
        y_offset_px = tile_row_offset * tile_h
    out_h = height if crop_height is None else crop_height
    # Corner-table vertex stage: world-space corners are baked at scene
    # build (device/scene.py corner_tables) so the per-frame geometry is
    # gather-free — only the view-projection runs here.
    clip_c = geometry.transform_corners(scene["corner_world"], view_proj)
    setup_out = geometry.triangle_setup(clip_c, None, scene["n_faces"], width, height)
    if stage == "geometry":
        return _stage_probe(setup_out["setup"], setup_out["valid"], setup_out["aabb"])
    if binning == "pairs":
        bins = geometry.bin_pairs(
            setup_out["aabb"],
            setup_out["valid"],
            tiles_x,
            tiles_y,
            tile_w,
            tile_h,
            ty_base=ty_base,
        )
    else:
        bins = geometry.bin_triangles(
            setup_out["aabb"],
            setup_out["valid"],
            tiles_x,
            tiles_y,
            tile_w,
            tile_h,
            bin_capacity,
            ty_base=ty_base,
        )
    overflow = bins["overflow"]
    if stage == "binning":
        return _stage_probe(bins["counts"], bins["offsets"], bins["pair_faces"])
    plan = raster.plan_segments(bins, segment_headroom=segment_headroom)
    if stage == "segments":
        return _stage_probe(
            plan["seg_tile"], plan["seg_slots"], plan["dropped"]
        )
    # Face attributes come straight from the build-time corner tables —
    # no per-frame vertex gathers (see transform_corners above).
    face_world = scene["corner_world"]
    face_normal = scene["corner_normal"]
    face_uv = scene["corner_uv"]
    light_kwargs = dict(
        light_direction=light_direction,
        light_color=light_color,
        ambient_amount=ambient_amount,
        specular_power=specular_power,
        clear_color=clear_color,
        max_anisotropy=max_anisotropy,
        blend=blend,
        texel_format=texture_format,
    )
    depth, fid = raster.RASTERIZERS[raster_impl](
        setup_out["setup"],
        plan,
        tile_h=tile_h,
        tile_w=tile_w,
        tiles_x=tiles_x,
        tiles_y=tiles_y,
        clear_depth=clear_depth,
        tile_row_offset=tile_row_offset,
    )  # (Hp, Wp) framebuffer layout: depth, face id
    if stage == "raster":
        return _stage_probe(depth, fid)
    dropped_segments = plan["dropped"]
    if shading == "forward":
        attrs = resolve.pack_resolve_attrs(
            setup_out["setup"],
            face_world,
            face_normal,
            face_uv,
            scene["face_tex"],
            scene["atlas"],
        )
        gbuf = resolve.resolve_gbuffer(
            fid,
            attrs,
            max_anisotropy=max_anisotropy,
            y_offset=y_offset_px,
        )
        if output == "gbuf":
            return {"gbuf": gbuf, "depth": depth, "fid": fid}
        if stage == "resolve":
            return _stage_probe(gbuf)
        framebuffer = shade.shade_gbuffer(
            gbuf, scene["atlas"]["texels"], camera_position, **light_kwargs
        )  # (4, Hp, Wp)
    else:
        shade_rows = shade.pack_shade_rows(
            setup_out["setup"],
            face_world,
            face_normal,
            face_uv,
            scene["face_tex"],
            scene["atlas"],
        )
        framebuffer = shade.shade_deferred(
            fid,
            shade_rows,
            scene["atlas"]["texels"],
            camera_position,
            y_offset=y_offset_px,
            **light_kwargs,
        )
    result = {
        "depth": present.crop_linear(depth, width, out_h),
        "bin_overflow": jnp.sum(overflow) + dropped_segments,
    }
    if output == "srgb_u8":
        result["color"] = present.encode_srgb_u8(framebuffer, width, out_h)
    else:
        result["color"] = present.crop_linear(framebuffer, width, out_h)
    return result


class Renderer:
    """Owns compiled pipeline + resident scene (the wgpu device+queue+
    pipeline+swapchain bundle of the reference)."""

    def __init__(
        self,
        scene: DeviceScene,
        config: RendererConfig | None = None,
        output: str = "srgb_u8",
    ):
        self.config = config or RendererConfig()
        cfg = self.config
        self.scene_host = scene
        self.texture_dtype = self._resolve_texture_dtype(scene, cfg.texture_dtype)
        self.scene = scene.device(self.texture_dtype)
        self.output = output
        self._configure_target(cfg.width, cfg.height)
        # Startup dump — the analog of the reference's adapter
        # properties/limits/features log (src/Renderer.zig:176-249).
        dev = jax.devices()[0]
        log.info(
            "renderer init: %dx%d | device %s (%s, %d of %d) | backend=%s",
            cfg.width,
            cfg.height,
            getattr(dev, "device_kind", "?"),
            dev.platform,
            dev.id,
            jax.device_count(),
            jax.default_backend(),
        )
        log.info(
            "scene: %d tris, %d verts, %d textures (%s), atlas %.1f MB",
            scene.n_faces,
            scene.n_vertices,
            len(scene.texture_uris),
            ", ".join(scene.texture_uris),
            scene.atlas.texels.nbytes / 1e6,
        )
        log.info(
            "pipeline: tiles %dx%d (%dx%d px), bin capacity %d, reversed-Z "
            "GreaterEqual, CCW front + back cull, clear %s",
            self.tiles_x,
            self.tiles_y,
            cfg.tile_w,
            cfg.tile_h,
            self.bin_capacity,
            cfg.clear_color,
        )

    @staticmethod
    def _resolve_texture_dtype(scene: DeviceScene, requested: str) -> str:
        """texture_dtype="auto": float16 normally, sRGB-u8 rows when the
        f16 atlas would exceed ~2 GB and the content is LDR — a bound on
        device memory, the analog of the reference keeping BC-compressed
        textures resident in VRAM."""
        if requested != "auto":
            return requested
        f16_bytes = scene.atlas.texels.nbytes // 2
        if f16_bytes > 2 << 30 and scene.atlas.max_value() <= 1.0 + 1e-6:
            return "srgb8"
        return "float16"

    # -- swapchain-equivalent: (re)configure render target ----------------
    def _configure_target(self, width: int, height: int) -> None:
        cfg = self.config
        self.width, self.height = width, height
        self.tiles_x = _round_up(width, cfg.tile_w) // cfg.tile_w
        self.tiles_y = _round_up(height, cfg.tile_h) // cfg.tile_h
        f_pad = int(self.scene_host.faces.shape[0])
        t_total = self.tiles_x * self.tiles_y
        # Binning path: "auto" is the pair sort (geometry.bin_pairs); the
        # chunked scan stays selectable for A/B.
        self.binning = "pairs" if cfg.binning == "auto" else cfg.binning
        self.bin_capacity, headroom = sizing(cfg, f_pad, self.binning)
        self.segment_headroom = headroom
        log.debug(
            "binning=%s capacity %d headroom %d (%d tiles)",
            self.binning,
            self.bin_capacity,
            headroom,
            t_total,
        )
        self.projection = math3d.perspective_inverse_depth(
            cfg.vfov, width / height, cfg.znear
        )
        self._frame_kwargs = dict(
            width=width,
            height=height,
            tile_h=cfg.tile_h,
            tile_w=cfg.tile_w,
            tiles_x=self.tiles_x,
            tiles_y=self.tiles_y,
            bin_capacity=self.bin_capacity,
            segment_headroom=self.segment_headroom,
            clear_depth=cfg.clear_depth,
            clear_color=cfg.clear_color,
            light_direction=cfg.light_direction,
            light_color=cfg.light_color,
            ambient_amount=cfg.ambient_amount,
            specular_power=cfg.specular_power,
            max_anisotropy=cfg.max_anisotropy,
            blend=cfg.blend,
            texture_format=(
                "srgb8" if self.texture_dtype == "srgb8" else "float"
            ),
            output=self.output,
            shading=cfg.shading,
            binning=self.binning,
        )
        self._frame_fn = jax.jit(
            functools.partial(render_frame, **self._frame_kwargs)
        )

    def recreate_swapchain(self, width: int, height: int) -> None:
        """Resize the render target; recompiles the frame function and
        recomputes the projection for the new aspect
        (src/Renderer.zig:631-661).

        A zero extent (minimized window) is IGNORED like the reference's
        deferral (src/Renderer.zig:631-636): rendering keeps the old
        target until a recreate with a usable extent arrives. (The
        reference replays the deferred recreation from renderFrame
        because its extent comes from the window system; here the
        embedder is the only extent source, so there is nothing to
        replay — the next nonzero recreate applies directly.)
        """
        if width == 0 or height == 0:
            log.debug("swapchain recreation skipped (zero extent %dx%d)", width, height)
            return
        self._configure_target(width, height)

    # -- frame -------------------------------------------------------------
    def frame_uniforms(self, camera: Camera):
        """FrameData.UniformData equivalent (src/Renderer.zig:127-131)."""
        view = camera.view_matrix()
        view_proj = (self.projection @ view).astype(np.float32)
        return jnp.asarray(view_proj), jnp.asarray(
            camera.position.astype(np.float32)
        )

    def render(self, camera: Camera):
        """Render one frame; returns dict of device arrays (async)."""
        return self.render_with_uniforms(*self.frame_uniforms(camera))

    def render_with_uniforms(self, view_proj, camera_position):
        """Render one frame from precomputed frame uniforms (the
        FrameData.UniformData path, src/Renderer.zig:960-963): benchmarks
        and flythroughs precompute their camera track so the timed loop
        measures only render + readback. Returns dict of device arrays
        (async): color, depth, bin_overflow."""
        return self._frame_fn(self.scene, view_proj, camera_position)

    def render_to_host(self, camera: Camera) -> np.ndarray:
        """Convenience: blocking render + readback of the color buffer,
        interleaved to (H, W, 4) on host (see present.interleave)."""
        from tpurast.present import interleave

        return interleave(np.asarray(jax.device_get(self.render(camera)["color"])))
