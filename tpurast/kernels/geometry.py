"""Geometry stage: vertex transform, triangle setup, tile binning (XLA).

Replaces the reference's vertex shader (shaders/src/basic.vert) and the
GPU's fixed-function primitive assembly / cull / bin hardware.

All shapes are static: faces are padded to a fixed count with a validity
mask; per-tile triangle lists have a fixed capacity with overflow counted
and reported (SURVEY.md §7 "hard parts" #2).

Rasterization math: clipless 2D-homogeneous setup. For clip-space
vertices c_i we build viewport-homogeneous coords
  v_i = (sx_i * w_i, sy_i * w_i, w_i)
with sx = (x + w) * W/2, sy = (w - y) * H/2 (WebGPU NDC y-up -> framebuffer
y-down). Edge functions are rows of adj([v0 v1 v2]):
  e_i(p) = E[i] . (px, py, 1)
Perspective-correct barycentric weights are e_i / sum(e); screen-linear
depth is z(p) = (e . z_clip) / (e . w_clip). det = e_0 . v_0 gives facing:
det < 0 is front (CCW in y-down framebuffer coords, the reference's
FrontFace=CCW + back cull, src/Renderer.zig:409-413).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Per-face setup row: [E(9), z_clip(3), w_clip(3), face_id, anchor_x,
# anchor_y, aabb_ymin, aabb_ymax, pad...]. Edge functions are ANCHORED:
# e_i(p) = a_i*(px - X0) + b_i*(py - Y0) + c_i with (X0, Y0) a per-face
# screen anchor. The adjugate is computed from anchor-translated
# homogeneous coords, so its magnitudes scale with the triangle's local
# extent instead of its absolute screen position — without this, f32
# cancellation in the cross products sprays phantom coverage off
# sub-pixel triangles (the fixed-point-edge-function problem, SURVEY §7
# hard-part #1). aabb_ymin/ymax are the screen-pixel y extent
# (conservative).
SETUP_WIDTH = 24
FIELD_FACE_ID = 15
FIELD_ANCHOR_X = 16
FIELD_ANCHOR_Y = 17


def transform_vertices(positions, normals, vert_prim, models, normal_mats, view_proj):
    """Vertex stage: model -> world -> clip, normals to world space.

    positions/normals: (V, 3); vert_prim: (V,) int32 primitive id;
    models: (P, 4, 4); normal_mats: (P, 3, 3); view_proj: (4, 4).
    Returns (clip (V, 4), world (V, 3), world_normal (V, 3)).

    Matches basic.vert:22-31: world = model * pos; clip = proj * view *
    world; normal = normal_matrix * normal (not renormalized here — the
    fragment stage normalizes, basic.frag:23).
    """
    m = models[vert_prim]  # (V, 4, 4)
    pos_h = jnp.concatenate([positions, jnp.ones_like(positions[:, :1])], axis=1)
    world_h = jnp.einsum("vij,vj->vi", m, pos_h)
    # HIGHEST: a default-precision f32 matmul may run in TF32 on the GPU,
    # moving vertices by ~1e-3 relative and breaking coverage ties.
    clip = jnp.matmul(world_h, view_proj.T, precision=jax.lax.Precision.HIGHEST)
    nm = normal_mats[vert_prim]
    world_normal = jnp.einsum("vij,vj->vi", nm, normals)
    return clip, world_h[:, :3], world_normal


def transform_corners(corner_world, view_proj):
    """Vertex stage over BUILD-TIME face-corner tables: world -> clip.

    corner_world: (F, 3, 3) world-space corner positions (the
    model->world half of basic.vert runs once at scene build,
    device/scene.py — model matrices are static per scene). Per frame
    only the view-projection runs, and there are NO per-frame vertex
    gathers. Returns clip (F, 3, 4).
    """
    f = corner_world.shape[0]
    w = corner_world.reshape(f * 3, 3)
    world_h = jnp.concatenate([w, jnp.ones_like(w[:, :1])], axis=1)
    # HIGHEST: see transform_vertices (TF32 would move vertices).
    clip = jnp.matmul(world_h, view_proj.T, precision=jax.lax.Precision.HIGHEST)
    return clip.reshape(f, 3, 4)


def triangle_setup(clip, faces, n_faces, width, height):
    """Per-triangle rasterization setup.

    clip: (V, 4) with faces (F, 3) int32 vertex indices, or pre-gathered
    corner clip (F, 3, 4) with faces=None (the no-gather corner path).
    n_faces: static or traced count of valid faces. Returns dict with:
      setup: (F, 16) f32 — edge matrix rows + z_clip + w_clip
      valid: (F,) bool — in-range, front-facing, non-degenerate
      aabb:  (F, 4) f32 — (minx, miny, maxx, maxy) in pixels of the
             triangle's part in front of the near plane
    """
    c = clip if faces is None else clip[faces]  # (F, 3, 4)
    w = c[..., 3]
    vx = (c[..., 0] + w) * (width * 0.5)
    vy = (w - c[..., 1]) * (height * 0.5)

    # Per-face screen anchor: the first w-positive vertex's pixel position
    # (rounded). Translating the homogeneous coords by the anchor keeps
    # the adjugate's magnitudes proportional to the triangle's local
    # extent — crucial for f32 coverage precision on small triangles.
    eps = jnp.float32(1e-20)
    w_ok = w > eps
    sx = jnp.where(w_ok, vx / jnp.where(w_ok, w, 1.0), 0.0)
    sy = jnp.where(w_ok, vy / jnp.where(w_ok, w, 1.0), 0.0)
    first_ok = jnp.argmax(w_ok, axis=-1)  # 0 if none
    ax = jnp.round(jnp.take_along_axis(sx, first_ok[:, None], axis=1)[:, 0])
    ay = jnp.round(jnp.take_along_axis(sy, first_ok[:, None], axis=1)[:, 0])
    any_ok = jnp.any(w_ok, axis=-1)
    ax = jnp.where(any_ok, jnp.clip(ax, -4 * width, 5 * width), 0.0)
    ay = jnp.where(any_ok, jnp.clip(ay, -4 * height, 5 * height), 0.0)

    v = jnp.stack([vx - ax[:, None] * w, vy - ay[:, None] * w, w], axis=-1)

    # Adjugate rows: e_i = cross(v_{i+1}, v_{i+2}) in the anchored frame.
    e0 = jnp.cross(v[:, 1], v[:, 2])
    e1 = jnp.cross(v[:, 2], v[:, 0])
    e2 = jnp.cross(v[:, 0], v[:, 1])
    det = jnp.sum(e0 * v[:, 0], axis=-1)

    face_ids = jnp.arange(c.shape[0], dtype=jnp.int32)
    in_range = face_ids < n_faces
    finite = jnp.all(jnp.isfinite(c.reshape(c.shape[0], -1)), axis=-1)
    front = det < 0.0  # CCW front under y-down framebuffer coords
    # Faces entirely behind the eye plane are invisible; without this
    # cull each one conservatively bins into EVERY tile (full-screen
    # AABB) — a camera inside the scene then explodes the pair count.
    valid = in_range & finite & front & any_ok

    # Screen AABB of the part of the triangle that can produce fragments.
    # The clip-volume test keeps z/w in [0, 1] with w > 0, i.e. the
    # half-space d = w - z >= 0 (the near plane under reversed-Z, where
    # z_clip is the constant znear). A triangle crossing that plane is
    # clipped to it for BINNING ONLY (coverage still comes from the edge
    # functions): its projected extent is then bounded, instead of a
    # full-screen AABB for every triangle that straddles the eye plane.
    d = w - c[..., 2]  # (F, 3)
    inside = d >= 0.0
    c_next = jnp.roll(c, -1, axis=1)
    d_next = jnp.roll(d, -1, axis=1)
    crosses = inside != (d_next >= 0.0)  # edge i -> i+1 crosses the plane
    t = d / jnp.where(crosses, d - d_next, 1.0)
    cand = jnp.concatenate([c, c + t[..., None] * (c_next - c)], axis=1)  # (F, 6, 4)
    cw = cand[..., 3]
    cand_ok = jnp.concatenate([inside, crosses], axis=1) & (cw > eps)
    cwd = jnp.where(cand_ok, cw, 1.0)
    csx = (cand[..., 0] + cw) * (width * 0.5) / cwd
    csy = (cw - cand[..., 1]) * (height * 0.5) / cwd
    big = jnp.float32(1e9)
    minx = jnp.min(jnp.where(cand_ok, csx, big), axis=-1)
    miny = jnp.min(jnp.where(cand_ok, csy, big), axis=-1)
    maxx = jnp.max(jnp.where(cand_ok, csx, -big), axis=-1)
    maxy = jnp.max(jnp.where(cand_ok, csy, -big), axis=-1)
    # Clipped vertices are computed, not given: widen their box a pixel
    # so rounding at the plane cannot drop a boundary pixel's tile.
    clipped = ~jnp.all(inside, axis=-1)
    pad = jnp.where(clipped, 1.0, 0.0)
    minx, miny, maxx, maxy = minx - pad, miny - pad, maxx + pad, maxy + pad
    aabb = jnp.stack([minx, miny, maxx, maxy], axis=-1)
    valid = valid & jnp.any(cand_ok, axis=-1)

    # Off-screen culling.
    on_screen = (maxx >= 0.0) & (maxy >= 0.0) & (minx < width) & (miny < height)
    valid = valid & on_screen

    setup = jnp.concatenate(
        [
            e0,
            e1,
            e2,
            c[..., 2],  # z_clip per vertex
            w,  # w_clip per vertex
            # Field 15: the face id itself (exact in f32 below 2^24).
            # Within a tile bin, face-id order == draw order, so the
            # raster kernel's later-wins tie-break can max over this
            # field directly and emit face ids without a slot->id pass.
            face_ids.astype(jnp.float32)[:, None],
            ax[:, None],  # field 16: anchor x
            ay[:, None],  # field 17: anchor y
            miny[:, None],  # field 18: screen-space y extent
            maxy[:, None],  # field 19
            jnp.zeros((c.shape[0], SETUP_WIDTH - 20), dtype=jnp.float32),
        ],
        axis=-1,
    ).astype(jnp.float32)
    return {"setup": setup, "valid": valid, "aabb": aabb, "det": det}


def _tile_ranges(aabb, valid, tiles_x, tiles_y, tile_w, tile_h, ty_base=0):
    """Clamped per-face tile ranges + tile-grid intersection culling.

    The intersection test runs on the UNCLAMPED ranges: a face whose AABB
    lies entirely outside the tile grid (possible for slab binning in the
    sharded path, where the grid covers one device's tile rows) must not
    bin at all — clamping alone would snap it onto the border tiles.

    ty_base (scalar tile rows, default 0) selects a slab: tile rows are
    computed in GLOBAL coordinates first and then offset, so every device
    floors the exact same quotients as a single-chip frame — slab bins
    are bit-identical to the corresponding rows of the full-frame bins.
    """
    btx0 = jnp.floor(aabb[:, 0] / tile_w)
    bty0 = jnp.floor(aabb[:, 1] / tile_h) - ty_base
    btx1 = jnp.floor(aabb[:, 2] / tile_w)
    bty1 = jnp.floor(aabb[:, 3] / tile_h) - ty_base
    intersects = (
        (btx1 >= 0.0) & (bty1 >= 0.0) & (btx0 < tiles_x) & (bty0 < tiles_y)
    )
    tx0 = jnp.clip(btx0, 0, tiles_x - 1).astype(jnp.int32)
    ty0 = jnp.clip(bty0, 0, tiles_y - 1).astype(jnp.int32)
    tx1 = jnp.clip(btx1, 0, tiles_x - 1).astype(jnp.int32)
    ty1 = jnp.clip(bty1, 0, tiles_y - 1).astype(jnp.int32)
    return tx0, ty0, tx1, ty1, valid & intersects


# Binning defaults, shared with the renderer's segment-headroom sizing
# (total pairs <= TILES_PER_FACE*F + HUGE_BUDGET*T).
TILES_PER_FACE = 8
HUGE_BUDGET = 64


def bin_pairs(
    aabb,
    valid,
    tiles_x,
    tiles_y,
    tile_w,
    tile_h,
    tiles_per_face: int = TILES_PER_FACE,
    huge_budget: int = HUGE_BUDGET,
    ty_base=0,
):
    """Pair-expansion binning: O(F * tiles_per_face + pairs log pairs).

    The scan path below (bin_triangles) builds a dense (T, chunk) overlap
    mask per face chunk — O(T x F) work that dominates 4K instanced
    scenes (T ~ 2k, F ~ 1.2M). This path instead emits (tile, face)
    pairs directly and sorts them by (tile, face) with one 2-key
    lax.sort; within a tile the secondary key keeps draw order exact.
    No scatters and no dense T x F intermediates.

      * round j in [0, tiles_per_face): face f contributes its j-th
        overlapped tile (row-major over its AABB tile range) — pure
        vectorized arithmetic over (TPF, F);
      * faces spanning more tiles ("huge": near-plane crossers,
        close-up geometry) are picked out with one top_k (first
        huge_budget in draw order) and contribute a dense (budget, T)
        round; excess huge faces are dropped and counted.

    Returns dict:
      pair_faces: (P,) i32 face ids sorted by (tile, face); P is static
      pair_tiles: (P,) i32 matching tile ids (t = invalid sentinel)
      offsets:    (T + 1,) i32 — tile t's faces at [offsets[t], offsets[t+1])
      counts:     (T,) i32
      overflow:   scalar i32 dropped pair count (huge faces beyond budget)

    Both binning paths emit the same bins (see renderer._configure_target
    for the choice).

    Within a tile, pairs sort by the face's QUANTIZED screen-y extent
    (8-row buckets) before draw order. Order within a bin is free to
    choose: the raster merge is commutative (max depth, ties to max
    face id) and the resolve gathers by face id. The bucket rides the
    sort key's low bits (key = tile * YB + ybucket), so the 2-operand
    sort cost is unchanged.
    """
    f = aabb.shape[0]
    t = tiles_x * tiles_y
    yb = 1024  # y-bucket slots per tile key (4320px / 8 rows = 540 max)
    tx0, ty0, tx1, ty1, valid = _tile_ranges(
        aabb, valid, tiles_x, tiles_y, tile_w, tile_h, ty_base
    )
    span_x = tx1 - tx0 + 1
    span_y = ty1 - ty0 + 1
    span = jnp.where(valid, span_x * span_y, 0)
    face_ids = jnp.arange(f, dtype=jnp.int32)
    huge = valid & (span > tiles_per_face)
    ybucket = jnp.clip(
        jnp.floor(aabb[:, 1] * (1.0 / 8.0)), 0, yb - 1
    ).astype(jnp.int32)

    # Rounds: (TPF, F) j-th tile of each small face.
    j = jnp.arange(tiles_per_face, dtype=jnp.int32)[:, None]  # (TPF, 1)
    sx = jnp.maximum(span_x, 1)[None, :]
    jx = j % sx
    jy = j // sx
    tile_j = (ty0[None, :] + jy) * tiles_x + (tx0[None, :] + jx)  # (TPF, F)
    ok = (valid & ~huge)[None, :] & (j < span[None, :])
    keys_small = jnp.where(ok, tile_j * yb + ybucket[None, :], t * yb).reshape(-1)
    vals_small = jnp.broadcast_to(face_ids[None, :], (tiles_per_face, f)).reshape(-1)

    # Huge faces: first huge_budget in draw order via one top_k.
    hb = min(huge_budget, f)
    hw = jnp.where(huge, f - face_ids, 0)
    _, hidx = jax.lax.top_k(hw, hb)  # (HB,) face indices
    h_ok_face = huge[hidx]  # (HB,) bool — False when fewer than HB huge
    jh = jnp.arange(t, dtype=jnp.int32)[None, :]  # (HB, T) worst case
    hsx = jnp.maximum(span_x[hidx], 1)[:, None]
    hx = jh % hsx
    hy = jh // hsx
    h_tile = (ty0[hidx][:, None] + hy) * tiles_x + tx0[hidx][:, None] + hx
    h_ok = h_ok_face[:, None] & (jh < span[hidx][:, None])
    keys_huge = jnp.where(
        h_ok, h_tile * yb + ybucket[hidx][:, None], t * yb
    ).reshape(-1)
    vals_huge = jnp.broadcast_to(hidx[:, None], (hb, t)).reshape(-1)

    keys = jnp.concatenate([keys_small, keys_huge])
    vals = jnp.concatenate([vals_small, vals_huge])
    pair_keys, pair_faces = jax.lax.sort((keys, vals), num_keys=2)
    pair_tiles = pair_keys // yb

    # Per-tile extents via vectorized binary search over the sorted keys.
    offsets = jnp.searchsorted(pair_keys, jnp.arange(t + 1, dtype=jnp.int32) * yb)
    offsets = offsets.astype(jnp.int32)
    counts = jnp.diff(offsets)
    n_huge = jnp.sum(huge, dtype=jnp.int32)
    h_excess = jnp.maximum(n_huge - huge_budget, 0)
    # Each dropped huge face loses all its tiles; report dropped PAIRS
    # like the scan path (span summed over the excess faces).
    dropped = jnp.sum(jnp.where(huge, span, 0)) - jnp.sum(
        jnp.where(h_ok_face, span[hidx], 0)
    )
    return {
        "pair_faces": pair_faces,
        "pair_tiles": pair_tiles,
        "offsets": offsets,
        "counts": counts,
        "overflow": dropped,
    }


def bin_triangles(
    aabb,
    valid,
    tiles_x,
    tiles_y,
    tile_w,
    tile_h,
    pair_capacity,
    tiles_per_face: int = TILES_PER_FACE,
    huge_budget: int = HUGE_BUDGET,
    ty_base=0,
    face_chunk: int = 8192,
):
    """Tiled binning: chunked rank-by-cumsum scan -> COMPACT pair lists.

    Draw-order ranks come from a dense (T, chunk) overlap mask + cumsum —
    scatter-free, compute-bound — processed over face chunks inside a
    lax.scan so memory stays bounded. Two passes: pass 1 accumulates
    per-tile counts (one mask sum per chunk), then per-tile offsets are
    one exclusive cumsum; pass 2 recomputes ranks and scatters face ids
    at offsets[tile] + rank into ONE compact (P,) pair buffer — the same
    output form as bin_pairs, with no (T, K) padded bin matrix and no
    sort.

    Per chunk:
      * "small" faces (AABB spanning <= tiles_per_face tiles) enumerate
        their (face, tile) pairs explicitly and scatter at rank slots;
      * "huge" faces (near-plane spanning / close-up geometry, rare) are
        compacted up to a GLOBAL huge_budget per frame and scattered
        against every tile they overlap (arena-style full-screen floors
        plus close-up props easily reach ~10; 64 leaves headroom — the
        cost is an (HB, T) enumeration per chunk, small next to the
        (T, CF) mask). Excess huge faces are dropped, counted, and
        EXCLUDED from counts/ranks (a counted-but-unwritten face would
        leave a stale slot that rasterizes as face 0).

    Returns the bin_pairs dict: pair_faces (P,), offsets (T+1,),
    counts (T,), overflow (scalar dropped-pair count, huge drops plus
    pair_capacity truncation).
    """
    f = aabb.shape[0]
    t = tiles_x * tiles_y
    p_cap = pair_capacity
    tx0, ty0, tx1, ty1, valid = _tile_ranges(
        aabb, valid, tiles_x, tiles_y, tile_w, tile_h, ty_base
    )
    span_x = tx1 - tx0 + 1
    span_y = ty1 - ty0 + 1
    span = jnp.where(valid, span_x * span_y, 0)
    face_ids = jnp.arange(f, dtype=jnp.int32)
    small = valid & (span <= tiles_per_face)
    huge = valid & (span > tiles_per_face)

    cf = min(face_chunk, f)
    f_pad = -(-f // cf) * cf
    n_chunks = f_pad // cf

    def pad(x, fill=0):
        return jnp.pad(x, (0, f_pad - f), constant_values=fill).reshape(n_chunks, cf)

    xs = {
        "tx0": pad(tx0),
        "ty0": pad(ty0),
        "tx1": pad(tx1, -1),
        "ty1": pad(ty1, -1),
        "span_x": pad(span_x),
        "span": pad(span),
        "small": pad(small.astype(jnp.int32)),
        "huge": pad(huge.astype(jnp.int32)),
        "fid": pad(face_ids),
    }
    tile_col = (jnp.arange(t, dtype=jnp.int32) % tiles_x)[:, None]  # (T, 1)
    tile_row = (jnp.arange(t, dtype=jnp.int32) // tiles_x)[:, None]
    j = jnp.arange(tiles_per_face, dtype=jnp.int32)[None, :]  # (1, TPF)
    lid = jnp.arange(cf, dtype=jnp.int32)

    def chunk_fields(x, huge_seen):
        """Shared mask/rank precursors; identical in both passes."""
        hugec = x["huge"] > 0
        hslot = jnp.cumsum(hugec, dtype=jnp.int32) - 1 + huge_seen
        hkeep = hugec & (hslot < huge_budget)
        written = (x["small"] > 0) | hkeep  # faces that will be scattered
        maskc = (
            written[None, :]
            & (tile_col >= x["tx0"][None, :])
            & (tile_col <= x["tx1"][None, :])
            & (tile_row >= x["ty0"][None, :])
            & (tile_row <= x["ty1"][None, :])
        )  # (T, CF)
        n_huge = jnp.sum(hugec, dtype=jnp.int32)
        return maskc, hslot, hkeep, n_huge

    # ---- pass 1: per-tile counts ----------------------------------------
    def count_step(carry, x):
        counts, huge_seen = carry
        maskc, _, _, n_huge = chunk_fields(x, huge_seen)
        return (counts + jnp.sum(maskc, axis=1, dtype=jnp.int32), huge_seen + n_huge), None

    (counts, n_huge_total), _ = jax.lax.scan(
        count_step, (jnp.zeros(t, dtype=jnp.int32), jnp.int32(0)), xs
    )
    offsets = jnp.concatenate(
        [jnp.zeros(1, dtype=jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)]
    )

    # ---- pass 2: rank + scatter into the compact pair buffer ------------
    def write_step(carry, x):
        pair_faces, base, huge_seen = carry
        maskc, hslot, hkeep, n_huge = chunk_fields(x, huge_seen)
        rank = jnp.cumsum(maskc, axis=1, dtype=jnp.int32) - 1 + base[:, None]

        # Small-face pairs.
        jx = j % jnp.maximum(x["span_x"], 1)[:, None]
        jy = j // jnp.maximum(x["span_x"], 1)[:, None]
        pair_tile = (x["ty0"][:, None] + jy) * tiles_x + (x["tx0"][:, None] + jx)
        pair_ok = (x["small"] > 0)[:, None] & (j < x["span"][:, None])
        pair_rank = rank.reshape(-1)[
            jnp.where(pair_ok, pair_tile * cf + lid[:, None], 0)
        ]
        dest = jnp.where(
            pair_ok, offsets[jnp.where(pair_ok, pair_tile, 0)] + pair_rank, p_cap
        )
        pair_faces = pair_faces.at[dest.reshape(-1)].set(
            jnp.broadcast_to(x["fid"][:, None], dest.shape).reshape(-1), mode="drop"
        )

        # Huge faces of this chunk: compact the kept ones, then enumerate
        # each one's own tile range (up to every tile — the camera-
        # inside-geometry / near-plane-crossing case).
        hdest = jnp.where(hkeep, hslot - huge_seen, huge_budget)
        hcol = (
            jnp.zeros(huge_budget + 1, dtype=jnp.int32)
            .at[jnp.clip(hdest, 0, huge_budget)]
            .set(lid, mode="promise_in_bounds")
        )[:huge_budget]
        n_kept = jnp.sum(hkeep, dtype=jnp.int32)
        h_active = (jnp.arange(huge_budget) < n_kept)[:, None]
        h_span_x = jnp.maximum(x["span_x"][hcol], 1)[:, None]
        h_span = x["span"][hcol][:, None]
        jh = jnp.arange(t, dtype=jnp.int32)[None, :]  # (1, T) worst case
        hx = jh % h_span_x
        hy = jh // h_span_x
        h_tile = (x["ty0"][hcol][:, None] + hy) * tiles_x + x["tx0"][hcol][:, None] + hx
        h_ok = h_active & (jh < h_span)  # (HB, T)
        h_rank = rank.reshape(-1)[
            jnp.where(h_ok, h_tile * cf + hcol[:, None], 0)
        ]
        h_dest = jnp.where(
            h_ok, offsets[jnp.where(h_ok, h_tile, 0)] + h_rank, p_cap
        )
        pair_faces = pair_faces.at[h_dest.reshape(-1)].set(
            jnp.broadcast_to(x["fid"][hcol][:, None], h_dest.shape).reshape(-1),
            mode="drop",
        )

        return (
            pair_faces,
            base + jnp.sum(maskc, axis=1, dtype=jnp.int32),
            huge_seen + n_huge,
        ), None

    init = (
        jnp.zeros(p_cap, dtype=jnp.int32),
        jnp.zeros(t, dtype=jnp.int32),
        jnp.int32(0),
    )
    (pair_faces, _, _), _ = jax.lax.scan(write_step, init, xs)

    # Dropped pairs: huge faces beyond the global budget lose their whole
    # span; pairs past pair_capacity are truncated by the drop-mode
    # scatter (and show up as offsets exceeding p_cap).
    hb = min(huge_budget, f)
    hkeep_all_w = jnp.where(huge, f - face_ids, 0)
    _, hidx = jax.lax.top_k(hkeep_all_w, hb)
    kept_span = jnp.sum(jnp.where(huge[hidx], span[hidx], 0))
    huge_pairs_dropped = jnp.sum(jnp.where(huge, span, 0)) - kept_span
    cap_dropped = jnp.maximum(offsets[-1] - p_cap, 0)
    return {
        "pair_faces": pair_faces,
        "offsets": jnp.minimum(offsets, p_cap),
        "counts": jnp.diff(jnp.minimum(offsets, p_cap)),
        "overflow": huge_pairs_dropped + cap_dropped,
    }
