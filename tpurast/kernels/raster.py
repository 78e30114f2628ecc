"""Visibility-buffer rasterization over binned screen tiles.

The screen is divided into tiles; binning (kernels/geometry.py) produced
a per-tile list of triangles. The segment plan groups each tile's list
into CHUNK-triangle segments laid out consecutively per tile, with the
per-face setup rows pre-gathered in segment order (gather_segment_rows),
so a tile's triangles are one contiguous run of setup rows.

Two formulations compute the same visibility buffer:

  * rasterize_tiles — a Pallas kernel compiled through Triton. One program
    owns one tile: it reads its run of setup rows itself (start/count
    tables, no scalar prefetch), walks the tile's triangles in a dynamic
    fori_loop (data-dependent trip count: a sparse tile costs a few
    iterations, a dense one many), keeps depth and face id in registers,
    and stores the tile once. Programs never share output, so the order
    in which the GPU schedules them does not matter.
  * rasterize_tiles_plain — the plain jax.numpy formulation: a dense edge
    test of every segment's CHUNK triangles against every pixel of its
    tile, a max over the triangle axis, and a per-tile max across
    segments. It evaluates padded lanes and whole tiles, and is the
    reference the kernel is checked against.

The per-pixel result is the reversed-Z depth plus the winning *face id*
(visibility buffer; shading happens once per pixel downstream).
Draw-order semantics match wgpu: depth compare GreaterEqual
(src/Renderer.zig:414-417) means max depth wins and, on ties, the later
draw wins. Face ids are in draw order, so both formulations take the
lexicographic max of (depth, face id) — independent of the order in
which triangles are visited.

Replaces the GPU rasterizer + depth unit state of src/Renderer.zig:
396-462/:1014: triangle list, CCW front + back cull (in geometry setup),
Depth32Float GreaterEqual, depth clear 0.0, no MSAA. Fragments with z
outside [0,1] are discarded (clip-volume z test — with clipless
homogeneous rasterization this replaces near-plane polygon clipping).
Top-left fill rule on shared edges matches Vulkan/D3D rules.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from tpurast import kernels as _k
from tpurast.kernels.geometry import (
    FIELD_ANCHOR_X,
    FIELD_ANCHOR_Y,
    FIELD_FACE_ID,
)

CHUNK = 128  # triangles per segment

# Segments evaluated at once by the plain formulation (bounds its dense
# (batch, CHUNK, tile pixels) intermediates).
PLAIN_SEGMENT_BATCH = 256


def _edge_covered(e, a, b):
    """Coverage for one edge with interior-negative convention and the
    top-left fill rule: on-edge pixels covered iff the edge gradient
    points right (a < 0 -> left edge) or the edge is horizontal with the
    interior below (a == 0 and b < 0 -> top edge)."""
    on_edge_ok = (a < 0.0) | ((a == 0.0) & (b < 0.0))
    return (e < 0.0) | ((e == 0.0) & on_edge_ok)


def _fragment(px, py, f):
    """Coverage and depth of triangle setup `f` at pixel centers (px, py).

    f(k) returns setup field k, broadcastable against px/py. Shared
    verbatim by both formulations so they evaluate the same arithmetic.
    Returns (covered bool, z f32).
    """
    # Anchored evaluation: coordinates relative to the per-face anchor
    # keep products small (f32 precision for tiny triangles).
    pxr = px - f(FIELD_ANCHOR_X)
    pyr = py - f(FIELD_ANCHOR_Y)
    e0 = pxr * f(0) + pyr * f(1) + f(2)
    e1 = pxr * f(3) + pyr * f(4) + f(5)
    e2 = pxr * f(6) + pyr * f(7) + f(8)
    # Two sign regions: all-negative is the ordinary interior; the
    # all-positive region only exists for triangles crossing w=0
    # (external triangles, their far sheet). The positive test is GATED
    # on an actual w-crossing — for ordinary triangles the region is
    # analytically empty but float noise on sub-pixel triangles can make
    # all three e's positive, spraying phantom dust across the screen.
    crossing = (f(12) <= 0.0) | (f(13) <= 0.0) | (f(14) <= 0.0)
    cov_n = (
        _edge_covered(e0, f(0), f(1))
        & _edge_covered(e1, f(3), f(4))
        & _edge_covered(e2, f(6), f(7))
    )
    cov_p = (
        crossing
        & _edge_covered(-e0, -f(0), -f(1))
        & _edge_covered(-e1, -f(3), -f(4))
        & _edge_covered(-e2, -f(6), -f(7))
    )
    esum = e0 + e1 + e2
    ez = e0 * f(9) + e1 * f(10) + e2 * f(11)
    ew = e0 * f(12) + e1 * f(13) + e2 * f(14)
    # Interpolated view depth w(p) = ew/esum must be positive (in front
    # of the eye); z in [0, 1] is the clip-volume test.
    w_front = (ew * esum) > 0.0
    z = ez / jnp.where(ew == 0.0, jnp.float32(1e-30), ew)
    z_ok = (z >= 0.0) & (z <= 1.0)
    return (cov_n | cov_p) & w_front & z_ok, z


# Sentinel block index for tail segments: no work. Small enough that
# sentinel * CHUNK stays far from int32 overflow, larger than any real
# per-tile block count (2^23 blocks = 2^30 triangles in one tile).
SENTINEL_BLOCK = 1 << 23


def build_segments_grouped(tile_counts, n_segments: int):
    """Segment tables, TILE-GROUPED: all of a tile's segments consecutive.

    Layout: tile t occupies segments [start[t], start[t] + blocks[t]);
    blocks[t] >= 1 always, extra blocks are granted by a waterfall over
    the headroom budget in tile order (early tiles first; a starved tile
    keeps block 0 and drops the rest, counted). Tail slots map to the
    LAST tile with a sentinel block index, so they carry no triangles.

    Returns (seg_tile (G,), seg_block (G,), start (T,), blocks (T,),
    n_dropped scalar).
    """
    t = tile_counts.shape[0]
    assert n_segments >= t
    extra = jnp.maximum(-(-tile_counts // CHUNK) - 1, 0)  # blocks beyond 0
    budget = jnp.int32(n_segments - t)
    csum_before = jnp.cumsum(extra) - extra
    allowed = jnp.clip(budget - csum_before, 0, extra)  # waterfall
    blocks = 1 + allowed
    start = jnp.cumsum(blocks) - blocks  # (T,) all distinct, < n_segments
    total = t + jnp.sum(allowed)

    tidx = jnp.arange(t, dtype=jnp.int32)
    marker = jnp.zeros(n_segments, dtype=jnp.int32).at[start].max(
        tidx, mode="promise_in_bounds"
    )
    seg_tile = jax.lax.associative_scan(jnp.maximum, marker)  # (G,)
    slot = jnp.arange(n_segments, dtype=jnp.int32)
    seg_block = slot - start[seg_tile]
    live = slot < total
    # Past `total`, seg_tile is already t-1 (the running max saturates at
    # the last marker); only the block index needs the no-op sentinel.
    seg_block = jnp.where(live, seg_block, jnp.int32(SENTINEL_BLOCK))
    dropped = jnp.sum(extra) - jnp.sum(allowed)
    return seg_tile, seg_block, start.astype(jnp.int32), blocks, dropped


def plan_segments(bins, *, segment_headroom: int):
    """Segment schedule from binned pairs (geometry.bin_triangles or
    geometry.bin_pairs — both emit the same compact pair-list form).

    Per-segment face ids come straight from the sorted pair list — no
    (T, K) padded bin matrix is ever materialized. The plan carries
    PAIR-SLOT indices (seg_slots); gather_segment_rows() composes them
    with the pair list into one row gather of G*CHUNK rows.

    tile_start[t] is the first setup row of tile t (segment start *
    CHUNK) and tile_count[t] the triangles rasterized there: the bin size
    capped by the segments the headroom granted (the rest is `dropped`).
    """
    counts = bins["counts"]
    offsets = bins["offsets"]
    pair_faces = bins["pair_faces"]
    t = counts.shape[0]
    n_segments = t + segment_headroom
    seg_tile, seg_block, start, blocks, dropped = build_segments_grouped(
        counts, n_segments
    )

    lane = jnp.arange(CHUNK, dtype=jnp.int32)[None, :]
    block = jnp.minimum(seg_block, SENTINEL_BLOCK)[:, None]
    slot = offsets[seg_tile][:, None] + block * CHUNK + lane  # (G, C)
    slot = jnp.clip(slot, 0, pair_faces.shape[0] - 1)
    seg_count = jnp.clip(counts[seg_tile] - seg_block * CHUNK, 0, CHUNK)
    return {
        "seg_tile": seg_tile,
        "seg_count": seg_count.astype(jnp.int32),
        "seg_slots": slot.reshape(-1),
        "pair_faces": pair_faces,
        "n_segments": n_segments,
        "tile_start": start * CHUNK,
        "tile_count": jnp.minimum(counts, blocks * CHUNK).astype(jnp.int32),
        "dropped": dropped,
    }


def gather_segment_rows(table, plan):
    """Per-segment row input: (G*CHUNK, W) from (F, W).

    Composes the indices (seg_faces = pair_faces[slots], then one row
    gather) instead of gathering rows in pair order first: the pair list
    has a STATIC worst-case length (TILES_PER_FACE * F), orders of
    magnitude more rows than G*CHUNK on heavy scenes.
    """
    seg_faces = plan["pair_faces"][plan["seg_slots"]]
    return table[seg_faces]


def _row0(tile_row_offset):
    if tile_row_offset is None:
        return jnp.zeros((1,), jnp.int32)
    return jnp.reshape(jnp.asarray(tile_row_offset, jnp.int32), (1,))


def _raster_kernel(
    start_ref,  # (T,) int32 — first setup row of each tile
    count_ref,  # (T,) int32 — triangles to rasterize in each tile
    row0_ref,  # (1,) int32 — global tile-row offset (sharded slabs)
    rows_ref,  # (G*CHUNK, SETUP_WIDTH) f32 — setup rows in segment order
    depth_ref,  # (tile_h, tile_w) f32 out
    fid_ref,  # (tile_h, tile_w) int32 out
    *,
    tile_h: int,
    tile_w: int,
    tiles_x: int,
    clear_depth: float,
):
    t = pl.program_id(0)
    # Pixel coordinates are GLOBAL (tile row + slab offset): a sharded
    # slab evaluates the exact same edge arithmetic as the single-card
    # frame, so slab output rows are bit-identical to a full-frame render.
    ty = t // tiles_x + row0_ref[0]
    tx = t % tiles_x
    base = start_ref[t]
    n = count_ref[t]
    iy = jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 0)
    ix = jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 1)
    # Pixel centers (+0.5: Vulkan/WebGPU sample points).
    px = (tx * tile_w + ix).astype(jnp.float32) + 0.5
    py = (ty * tile_h + iy).astype(jnp.float32) + 0.5

    def body(i, carry):
        zb, fb = carry
        r = base + i

        def f(k):
            return rows_ref[r, k]

        covered, z = _fragment(px, py, f)
        fid = f(FIELD_FACE_ID).astype(jnp.int32)
        better = covered & ((z > zb) | ((z == zb) & (fid > fb)))
        return jnp.where(better, z, zb), jnp.where(better, fid, fb)

    init = (
        jnp.full((tile_h, tile_w), clear_depth, jnp.float32),
        jnp.full((tile_h, tile_w), -1, jnp.int32),
    )
    zb, fb = jax.lax.fori_loop(0, n, body, init)
    depth_ref[...] = zb
    fid_ref[...] = fb


def _check_tile(tile_h: int, tile_w: int) -> None:
    for d in (tile_h, tile_w):
        if d <= 0 or d & (d - 1):
            raise ValueError(f"tile {tile_h}x{tile_w}: sides must be powers of two")


def rasterize_tiles(
    setup,  # (F, SETUP_WIDTH) f32 triangle setup (see geometry.SETUP_WIDTH)
    plan,  # from plan_segments
    *,
    tile_h: int,
    tile_w: int,
    tiles_x: int,
    tiles_y: int,
    clear_depth: float = 0.0,
    tile_row_offset=None,
):
    """Visibility raster through the Pallas kernel (one program per tile).

    Returns (depth (H, W) f32, fid (H, W) int32) in framebuffer layout,
    H = tiles_y*tile_h, W = tiles_x*tile_w; fid == -1 where no triangle
    covers the pixel. tile_row_offset (scalar int32, default 0) shifts
    pixel-coordinate evaluation down by whole tile rows WITHOUT changing
    which output rows are written (sharded slabs).
    """
    _check_tile(tile_h, tile_w)
    rows = gather_segment_rows(setup, plan)
    kernel = functools.partial(
        _raster_kernel,
        tile_h=tile_h,
        tile_w=tile_w,
        tiles_x=tiles_x,
        clear_depth=clear_depth,
    )
    out_spec = pl.BlockSpec((tile_h, tile_w), lambda t: (t // tiles_x, t % tiles_x))
    h, w = tiles_y * tile_h, tiles_x * tile_w
    depth, fid = pl.pallas_call(
        kernel,
        grid=(tiles_x * tiles_y,),
        in_specs=[pl.no_block_spec] * 4,
        out_specs=[out_spec, out_spec],
        out_shape=[
            jax.ShapeDtypeStruct((h, w), jnp.float32),
            jax.ShapeDtypeStruct((h, w), jnp.int32),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=1),
        interpret=_k.interpret_mode(),
        name="raster_tiles",
    )(plan["tile_start"], plan["tile_count"], _row0(tile_row_offset), rows)
    return depth, fid


def rasterize_tiles_plain(
    setup,
    plan,
    *,
    tile_h: int,
    tile_w: int,
    tiles_x: int,
    tiles_y: int,
    clear_depth: float = 0.0,
    tile_row_offset=None,
):
    """The plain jax.numpy formulation of rasterize_tiles (same result).

    Every segment's CHUNK triangles are tested densely against every
    pixel of its tile; the winner per pixel is the max depth, ties to the
    max face id (two exact max reductions); segments of one tile then
    merge by the same rule.
    """
    _check_tile(tile_h, tile_w)
    n_seg = plan["n_segments"]
    t_total = tiles_x * tiles_y
    p = tile_h * tile_w
    rows = gather_segment_rows(setup, plan).reshape(n_seg, CHUNK, -1)
    row0 = _row0(tile_row_offset)[0]
    lin = jnp.arange(p, dtype=jnp.int32)
    lane = jnp.arange(CHUNK, dtype=jnp.int32)[:, None]
    neg_inf = jnp.float32(-jnp.inf)

    def segment(args):
        seg_rows, tile, count = args  # (CHUNK, SW), (), ()
        ty = tile // tiles_x + row0
        tx = tile % tiles_x
        px = (tx * tile_w + lin % tile_w).astype(jnp.float32)[None, :] + 0.5
        py = (ty * tile_h + lin // tile_w).astype(jnp.float32)[None, :] + 0.5

        def f(k):
            return seg_rows[:, k : k + 1]  # (CHUNK, 1)

        covered, z = _fragment(px, py, f)
        covered = covered & (lane < count)
        zm = jnp.where(covered, z, neg_inf)
        z_best = jnp.max(zm, axis=0)  # (P,)
        fid = f(FIELD_FACE_ID).astype(jnp.int32)
        cand = jnp.where(covered & (zm == z_best[None, :]), fid, -1)
        return z_best, jnp.max(cand, axis=0)

    z_seg, f_seg = jax.lax.map(
        segment,
        (rows, plan["seg_tile"], plan["seg_count"]),
        batch_size=min(PLAIN_SEGMENT_BATCH, n_seg),
    )  # (G, P) each
    seg_tile = plan["seg_tile"]
    z_tile = jax.ops.segment_max(
        z_seg, seg_tile, num_segments=t_total, indices_are_sorted=True
    )
    f_tile = jax.ops.segment_max(
        jnp.where(z_seg == z_tile[seg_tile], f_seg, -1),
        seg_tile,
        num_segments=t_total,
        indices_are_sorted=True,
    )
    passes = (f_tile >= 0) & (z_tile >= clear_depth)
    depth = jnp.where(passes, z_tile, jnp.float32(clear_depth))
    fid = jnp.where(passes, f_tile, -1)

    def to_image(a):
        a = a.reshape(tiles_y, tiles_x, tile_h, tile_w)
        return a.transpose(0, 2, 1, 3).reshape(tiles_y * tile_h, tiles_x * tile_w)

    return to_image(depth), to_image(fid)


RASTERIZERS = {"kernel": rasterize_tiles, "plain": rasterize_tiles_plain}


@functools.partial(
    jax.jit,
    static_argnames=(
        "tile_h", "tile_w", "tiles_x", "tiles_y", "clear_depth",
        "segment_headroom", "impl",
    ),
)
def rasterize_visibility(
    bins,  # dict from geometry.bin_triangles / bin_pairs
    setup,  # (F, SETUP_WIDTH) f32 triangle setup (see geometry.SETUP_WIDTH)
    *,
    tile_h: int,
    tile_w: int,
    tiles_x: int,
    tiles_y: int,
    clear_depth: float = 0.0,
    segment_headroom: int = 2048,
    tile_row_offset=None,
    impl: str = "kernel",
):
    """Visibility raster to framebuffer-layout images.

    Returns (depth (H, W) f32, fid (H, W) int32, dropped scalar) with
    H = tiles_y*tile_h, W = tiles_x*tile_w; fid == -1 where no triangle
    covers the pixel. dropped > 0 means segment_headroom was too small
    for this frame and triangles were not rasterized. impl selects the
    kernel or the plain formulation.
    """
    plan = plan_segments(bins, segment_headroom=segment_headroom)
    depth, fid = RASTERIZERS[impl](
        setup,
        plan,
        tile_h=tile_h,
        tile_w=tile_w,
        tiles_x=tiles_x,
        tiles_y=tiles_y,
        clear_depth=clear_depth,
        tile_row_offset=tile_row_offset,
    )
    return depth, fid, plan["dropped"]
