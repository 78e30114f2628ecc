"""Forward attribute resolve: per-pixel G-buffer from the visibility pass.

Plain XLA. Each covered pixel gathers its winning face's attribute row
(pack_resolve_attrs: ~57 floats per face, a table that stays resident in
the GPU's L2 for demo-class scenes) by face id, then evaluates:

  * perspective-correct barycentrics from the face's anchored edge
    functions, and world/normal/UV interpolation;
  * analytic UV screen derivatives (closed-form gradients of the
    rational interpolant — no quad neighborhoods), the LOD, the mip pair
    and the anisotropic footprint;

writing a compact A_OUT-plane G-buffer. shade.shade_gbuffer then does the
texel-row gathers + lighting. The formulas and their op order are those
of shade.shade_deferred, so the forward and deferred paths agree
bit-for-bit on the same backend.

Texture info is carried as f32: mip offsets as offset/256 (exact — the
atlas aligns mip allocations to 256 quad rows, device/textures.py), mip
dimensions recomputed as max(floor(w0 * 2^-l), 1) by exact power-of-two
scaling.

Semantics replaced: the attribute-interpolation half of the GPU's
fixed-function rasterizer + the vertex-output interpolators feeding
shaders/src/basic.frag (reference pipeline src/Renderer.zig:396-462).
"""

from __future__ import annotations

import jax.numpy as jnp

# Attribute-table row layout (A_IN, per face), gathered per pixel:
#   0..8   edge matrix E (a0,b0,c0, a1,b1,c1, a2,b2,c2)
#   9,10   screen anchor x, y
#   11     face id
#   12..17 per-vertex UV (u0,v0, u1,v1, u2,v2)
#   18..26 per-vertex world position (v0 xyz, v1 xyz, v2 xyz)
#   27..35 per-vertex world normal
#   36..51 per-mip atlas offset / 256 (16 levels)
#   52,53  mip-0 width, height
#   54     mip count
#   55     texture id (exact small integer in f32)
A_IN = 56

# G-buffer plane layout (A_OUT planes, per pixel):
#   0..2 world | 3..5 normal | 6,7 u,v | 8 off0/256 | 9,10 tw0,th0
#   11,12 tw1,th1 | 13 mip frac | 14,15 aniso major du,dv
#   16 matched flag | 17 aniso probe span (shade.aniso_footprint)
# (No off1: the parent-mip texels ride the own-mip atlas row,
# device/textures.py, so only the parent DIMENSIONS are needed.)
A_OUT = 18
MAX_MIPS = 16


def pack_resolve_attrs(setup, face_world, face_normal, face_uv, face_tex, atlas):
    """(F, A_IN) f32 per-face attribute table (O(F) per frame, XLA).

    atlas offsets must be 256-row aligned (device/textures.py build_atlas).
    """
    f = setup.shape[0]
    offsets = atlas["offsets"]  # (T, 16) i32, 256-aligned
    sizes = atlas["sizes"]  # (T, 16, 2) i32
    n_mips = atlas["n_mips"]  # (T,) i32
    tex_cols = jnp.concatenate(
        [
            (offsets // 256).astype(jnp.float32),
            sizes[:, 0, 0:1].astype(jnp.float32),  # mip-0 width
            sizes[:, 0, 1:2].astype(jnp.float32),  # mip-0 height
            n_mips.astype(jnp.float32)[:, None],
        ],
        axis=1,
    )[face_tex]  # (F, 19)
    return jnp.concatenate(
        [
            setup[:, 0:9],  # E
            setup[:, 16:18],  # anchor
            setup[:, 15:16],  # face id
            face_uv.reshape(f, 6),
            face_world.reshape(f, 9),
            face_normal.reshape(f, 9),
            tex_cols,
            face_tex.astype(jnp.float32)[:, None],
        ],
        axis=1,
    ).astype(jnp.float32)


def resolve_gbuffer(
    fid,  # (H, W) int32 winning face id, -1 = none
    attrs,  # (F, A_IN) f32 from pack_resolve_attrs
    *,
    max_anisotropy: int = 1,
    y_offset=0,
):
    """Per-pixel G-buffer (A_OUT, H, W) f32; uncovered pixels are zero.

    y_offset (scalar pixel rows, default 0): sharded slabs interpolate
    with GLOBAL pixel rows, bit-identical to a single-card frame.
    """
    h, w = fid.shape
    matched = fid >= 0
    rows = attrs[jnp.maximum(fid, 0)]  # (H, W, A_IN): THE gather

    def s(i):
        return rows[..., i]  # (H, W)

    y0 = jnp.asarray(y_offset, jnp.float32)
    px = jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5 - s(9)
    py = jnp.arange(h, dtype=jnp.float32)[:, None] + y0 + 0.5 - s(10)
    e0 = s(0) * px + s(1) * py + s(2)
    e1 = s(3) * px + s(4) * py + s(5)
    e2 = s(6) * px + s(7) * py + s(8)
    esum = e0 + e1 + e2
    # Mirrors shade._safe_div so forward == deferred bit-for-bit.
    eps = jnp.float32(1e-30)
    den = jnp.where(jnp.abs(esum) < eps, jnp.where(esum < 0, -eps, eps), esum)
    inv = jnp.float32(1.0) / den
    u0 = e0 * inv
    u1 = e1 * inv
    u2 = e2 * inv

    def interp(b0, b1, b2):
        return u0 * s(b0) + u1 * s(b1) + u2 * s(b2)

    uv_u = interp(12, 14, 16)
    uv_v = interp(13, 15, 17)
    wx, wy, wz = interp(18, 21, 24), interp(19, 22, 25), interp(20, 23, 26)
    nx_, ny_, nz_ = interp(27, 30, 33), interp(28, 31, 34), interp(29, 32, 35)

    # Analytic UV screen derivatives (uv = N(p)/D(p), both linear).
    d_x = s(0) + s(3) + s(6)
    d_y = s(1) + s(4) + s(7)
    inv2 = inv * inv

    def duv(c0, c1, c2):
        nval = e0 * s(c0) + e1 * s(c1) + e2 * s(c2)
        gx = s(0) * s(c0) + s(3) * s(c1) + s(6) * s(c2)
        gy = s(1) * s(c0) + s(4) * s(c1) + s(7) * s(c2)
        return (gx * esum - nval * d_x) * inv2, (gy * esum - nval * d_y) * inv2

    du_dx, du_dy = duv(12, 14, 16)
    dv_dx, dv_dy = duv(13, 15, 17)

    w0 = s(52)
    h0 = s(53)
    n_mips = s(54)
    rho2_x = (du_dx * w0) ** 2 + (dv_dx * h0) ** 2
    rho2_y = (du_dy * w0) ** 2 + (dv_dy * h0) ** 2
    if max_anisotropy > 1:
        from tpurast.kernels.shade import aniso_footprint

        rho2, maj_du, maj_dv, span = aniso_footprint(
            rho2_x, rho2_y, du_dx, du_dy, dv_dx, dv_dy, max_anisotropy
        )
    else:
        rho2 = jnp.maximum(rho2_x, rho2_y)
        maj_du = jnp.zeros_like(rho2)
        maj_dv = maj_du
        span = maj_du

    lod = 0.5 * jnp.log2(jnp.maximum(rho2, 1e-24))
    lod = jnp.clip(lod, 0.0, n_mips - 1.0)
    l0 = jnp.floor(lod)
    l1 = jnp.minimum(l0 + 1.0, n_mips - 1.0)
    tfrac = lod - l0

    # Mip select by index. Level dims derive from mip 0 by exact
    # power-of-two scaling: max(floor(w0 * 2^-l), 1). Only the level-0
    # tap needs an atlas offset — parent-mip texels ride the same row.
    l0i = jnp.clip(l0.astype(jnp.int32), 0, MAX_MIPS - 1)
    l1i = jnp.clip(l1.astype(jnp.int32), 0, MAX_MIPS - 1)
    off0 = jnp.take_along_axis(rows[..., 36:52], l0i[..., None], axis=-1)[..., 0]
    pow2 = jnp.asarray([2.0**-i for i in range(MAX_MIPS)], jnp.float32)
    pow0 = pow2[l0i]
    pow1 = pow2[l1i]
    tw0 = jnp.maximum(jnp.floor(w0 * pow0), 1.0)
    th0 = jnp.maximum(jnp.floor(h0 * pow0), 1.0)
    tw1 = jnp.maximum(jnp.floor(w0 * pow1), 1.0)
    th1 = jnp.maximum(jnp.floor(h0 * pow1), 1.0)

    planes = jnp.stack(
        [
            wx, wy, wz,
            nx_, ny_, nz_,
            uv_u, uv_v,
            off0, tw0, th0,
            tw1, th1,
            tfrac, maj_du, maj_dv,
            jnp.ones_like(wx), span,
        ],
        axis=0,
    )  # (A_OUT, H, W)
    return jnp.where(matched[None], planes, 0.0)
