"""Multi-chip SPMD rendering: framebuffer tile-row sharding over a mesh.

The reference is single-GPU; its parallelism is the rasterizer hardware
(SURVEY §2.5). Here the scale-out axis is screen space: tile rows shard
across devices on a 1-D mesh ("tiles" axis). Rasterization is
embarrassingly parallel after binning — each device bins and rasterizes
only its slab, with no halo exchange (SURVEY §5 "long-context" analog).
Scene buffers are replicated (small: MBs); per-slab framebuffers
concatenate into the output sharding, and the only collective is a psum
of the bin-overflow counter (serves as the cross-chip health check).

There is NO sharded pipeline fork: every device runs the SAME
renderer.render_frame as a single chip, parameterized by its slab's
global tile-row offset. Every stage evaluates edges/attributes in GLOBAL
pixel coordinates (kernels/raster.py, kernels/resolve.py,
kernels/shade.py take a row offset; binning floors global tile rows
before offsetting, kernels/geometry._tile_ranges) — so each slab's
output is BIT-IDENTICAL to the corresponding rows of a single-chip
frame, for both shading modes and both binning paths.
"""

from __future__ import annotations

import functools

import jax
from jax.sharding import Mesh, PartitionSpec as P

from tpurast.renderer import render_frame, sizing


def render_frame_sharded(
    scene,
    view_proj,
    camera_position,
    *,
    mesh: Mesh,
    axis: str = "tiles",
    width: int,
    height: int,
    tiles_y_per_device: int,
    **frame_kwargs,
):
    """Jit-compatible multi-device frame: returns dict with the color
    framebuffer (sharded over rows) and the global bin overflow count.

    frame_kwargs are renderer.render_frame's static parameters (tile_h/
    tile_w/tiles_x/shading/binning/...), passed through untouched.
    """
    slab_h = tiles_y_per_device * frame_kwargs["tile_h"]

    def slab_fn(scene_rep, vp, cam):
        d = jax.lax.axis_index(axis)
        out = render_frame(
            scene_rep,
            vp,
            cam,
            width=width,
            height=height,  # full-frame viewport: global clip/cull/AABBs
            tiles_y=tiles_y_per_device,
            tile_row_offset=d * tiles_y_per_device,
            crop_height=slab_h,
            **frame_kwargs,
        )
        total_overflow = jax.lax.psum(out["bin_overflow"], axis)
        return out["color"], out["depth"], total_overflow

    color, depth, overflow = jax.shard_map(
        slab_fn,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        # Color is channel-planar (4, H, W): slabs concatenate on rows.
        out_specs=(P(None, axis, None), P(axis, None), P()),
        # Pallas calls don't carry varying-mesh-axis metadata yet.
        check_vma=False,
    )(scene, view_proj, camera_position)
    return {
        "color": color[:, :height, :width],
        "depth": depth[:height, :width],
        "bin_overflow": overflow,
    }


def make_sharded_renderer(scene_dev, config, mesh: Mesh, width: int, height: int):
    """Build a jitted multi-chip frame function for a given mesh.

    Pads the framebuffer so tile rows divide evenly across devices.
    Returns fn; fn(scene, view_proj, cam_pos) -> frame dict. Static
    sizing (binning path, pair capacity, segment headroom) mirrors
    Renderer._configure_target so the sharded frame runs the DEFAULT
    pipeline, not a special-cased one.
    """
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    tiles_x = -(-width // config.tile_w)
    tiles_y = -(-height // config.tile_h)
    tiles_y = -(-tiles_y // n_dev) * n_dev  # divisible by device count
    f_pad = int(scene_dev["faces"].shape[0])
    binning = "pairs" if config.binning == "auto" else config.binning
    cap, headroom = sizing(config, f_pad, binning)
    fn = jax.jit(
        functools.partial(
            render_frame_sharded,
            mesh=mesh,
            axis=axis,
            width=width,
            height=height,
            tiles_y_per_device=tiles_y // n_dev,
            tile_h=config.tile_h,
            tile_w=config.tile_w,
            tiles_x=tiles_x,
            bin_capacity=cap,
            segment_headroom=headroom,
            clear_depth=config.clear_depth,
            clear_color=config.clear_color,
            light_direction=config.light_direction,
            light_color=config.light_color,
            ambient_amount=config.ambient_amount,
            specular_power=config.specular_power,
            max_anisotropy=config.max_anisotropy,
            blend=config.blend,
            # Derive the sampler decode mode from the uploaded atlas
            # (srgb8 atlases are u8 arrays).
            texture_format=(
                "srgb8"
                if str(scene_dev["atlas"]["texels"].dtype) == "uint8"
                else "float"
            ),
            shading=config.shading,
            binning=binning,
        )
    )
    return fn
