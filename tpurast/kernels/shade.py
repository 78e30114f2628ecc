"""Shading: perspective-correct interpolation + lighting + texture.

Two paths share one sampling and lighting formula:

  * shade_gbuffer — the forward tail: kernels/resolve.py already
    interpolated everything per pixel, so this is texture taps + lighting.
  * shade_deferred — consumes the visibility buffer directly: one fat-row
    gather per pixel fetches everything about the winning triangle (edge
    setup, per-vertex world position / normal / UV, texture info packed
    into a 104-float row) and interpolates in place. It is the second
    formulation the forward path is checked against.

Common steps:
  1. Homogeneous edge functions are re-evaluated at the pixel; weights
     u_i = e_i / sum(e) are the perspective-correct barycentrics (see
     kernels/geometry.py).
  2. Mip level comes from analytic UV screen derivatives (closed-form
     gradients of the rational interpolant — no quad neighborhoods,
     SURVEY §7 hard-part #4).
  3. Trilinear = ONE row gather (own-mip quad + parent-mip window
     packed per row, device/textures.py) + in-register blends.
  4. Lighting: ambient + Lambert diffuse + Phong specular with the
     specular mask in albedo alpha — basic.frag:15-38, same constants.

All math is channel-planar: rgba live in separate (H, W) planes, and the
only channel-minor tensors are gathered rows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Fat-row layout for the per-face shading table (see pack_shade_rows):
# [setup(24) | world(9) | normal(9) | uv(6) | tex-info(49, int32 bitcast)]
# The texture info (per-mip atlas offset/width/height + mip count) is
# joined per FACE at pack time — one per-pixel gather fetches everything.
from tpurast.kernels.geometry import SETUP_WIDTH as _SETUP_WIDTH

ROW_WORLD = _SETUP_WIDTH            # 24..32
ROW_NORMAL = _SETUP_WIDTH + 9       # 33..41
ROW_UV = _SETUP_WIDTH + 18          # 42..47
ROW_TEXINFO = _SETUP_WIDTH + 24     # 48..96
SHADE_ROW_WIDTH = 104

# Texture-info row layout (int32): per-mip offset/width/height + mip count.
TEX_ROW_WIDTH = 49  # [offsets(16) | widths(16) | heights(16) | n_mips]


def pack_tex_table(atlas):
    """(TEX, 49) int32: per-texture mip offsets/sizes + mip count."""
    offsets = atlas["offsets"]  # (TEX, 16)
    sizes = atlas["sizes"]  # (TEX, 16, 2)
    n_mips = atlas["n_mips"]  # (TEX,)
    return jnp.concatenate(
        [
            offsets.astype(jnp.int32),
            sizes[..., 0].astype(jnp.int32),
            sizes[..., 1].astype(jnp.int32),
            n_mips.astype(jnp.int32)[:, None],
        ],
        axis=1,
    )


def pack_shade_rows(setup, face_world, face_normal, face_uv, face_tex, atlas):
    """Build the (F, 104) fat shading table (per frame, F-sized: cheap).

    Int32 texture info is bitcast into the f32 row (values survive the
    round trip exactly; atlas offsets exceed f32's 2^24 integer range so
    they cannot be stored as floats).
    """
    f = setup.shape[0]
    tex_rows = pack_tex_table(atlas)[face_tex]  # (F, 49) i32
    return jnp.concatenate(
        [
            setup,
            face_world.reshape(f, 9),
            face_normal.reshape(f, 9),
            face_uv.reshape(f, 6),
            jax.lax.bitcast_convert_type(tex_rows, jnp.float32),
            jnp.zeros((f, SHADE_ROW_WIDTH - ROW_TEXINFO - TEX_ROW_WIDTH), dtype=jnp.float32),
        ],
        axis=1,
    )


def _safe_div(a, b, eps=1e-30):
    return a / jnp.where(jnp.abs(b) < eps, jnp.where(b < 0, -eps, eps), b)


def _rnorm3(x, y, z):
    """1/||(x,y,z)|| planar, zero-safe."""
    return jax.lax.rsqrt(jnp.maximum(x * x + y * y + z * z, 1e-20))


def _trilerp(texels, off0, tw0, th0, tw1, th1, tfrac, u, v, texel_format="float"):
    """Trilinear sample with repeat addressing: ONE row gather.

    Atlas rows (device/textures.py) carry the own-mip 2x2 bilinear quad
    plus the 3x3 window of the parent mip anchored at ((x0-1)//2,
    (y0-1)//2) — the parent footprint for ANY sample point mapping to
    quad (x0, y0) lands inside that window at offset dx, dy in {0, 1},
    derived exactly below. Folding both mip taps into one row makes a
    trilinear sample one gather.

    Returns 4 planes (r, g, b, a) shaped like `u`.
    """
    wf = tw0.astype(jnp.float32)
    hf = th0.astype(jnp.float32)
    x = u * wf - 0.5
    y = v * hf - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = jnp.mod(x0.astype(jnp.int32), tw0)
    y0i = jnp.mod(y0.astype(jnp.int32), th0)
    # ONE transpose turns the gathered (..., 52) rows channel-planar.
    row = jnp.moveaxis(texels[off0 + y0i * tw0 + x0i], -1, 0)  # (52, ...)

    # Parent-mip footprint: same sample point in mip l+1 coordinates.
    wf1 = tw1.astype(jnp.float32)
    hf1 = th1.astype(jnp.float32)
    x1f = u * wf1 - 0.5
    y1f = v * hf1 - 0.5
    x1 = jnp.floor(x1f)
    y1 = jnp.floor(y1f)
    fx1 = x1f - x1
    fy1 = y1f - y1
    # Window anchor in unwrapped coords; dx, dy in {0, 1} by construction
    # for power-of-two mips (w1 == w0/2). The clip is exact where it can
    # bind: a dimension-1 mip (w1 == w0 == 1) has a uniform window, so
    # any in-range offset reads the same texel.
    dx = jnp.clip(x1 - jnp.floor((x0 - 1.0) * 0.5), 0.0, 1.0)
    dy = jnp.clip(y1 - jnp.floor((y0 - 1.0) * 0.5), 0.0, 1.0)

    # Per-axis 3-tap parent weights: (1-f, f) placed at offset (d, d+1).
    one = jnp.float32(1.0)
    wx1 = [(one - dx) * (one - fx1), (one - dx) * fx1 + dx * (one - fx1), dx * fx1]
    wy1 = [(one - dy) * (one - fy1), (one - dy) * fy1 + dy * (one - fy1), dy * fy1]
    w9 = [wy1[r] * wx1[c] for r in range(3) for c in range(3)]

    # Own-mip bilinear per channel + parent 3x3 weighted sum per channel.
    fx_i = one - fx
    fy_i = one - fy
    t_i = one - tfrac

    if texel_format == "srgb8":
        # u8 storage: RGB lanes are sRGB-encoded (decode with the exact
        # piecewise EOTF before filtering, like a GPU sampler on *_SRGB
        # formats); alpha lanes (the specular mask) are linear u8.
        def tex(i):
            c = row[i].astype(jnp.float32) * jnp.float32(1.0 / 255.0)
            if i % 4 == 3:
                return c
            return jnp.where(
                c <= 0.04045,
                c * jnp.float32(1.0 / 12.92),
                ((c + jnp.float32(0.055)) * jnp.float32(1.0 / 1.055))
                ** jnp.float32(2.4),
            )
    else:
        def tex(i):  # texel plane i of the gathered rows, upcast lazily
            return row[i].astype(jnp.float32)

    out = []
    for c in range(4):
        top = tex(c) * fx_i + tex(4 + c) * fx
        bot = tex(8 + c) * fx_i + tex(12 + c) * fx
        c0 = top * fy_i + bot * fy
        c1 = w9[0] * tex(16 + c)
        for k in range(1, 9):
            c1 = c1 + w9[k] * tex(16 + 4 * k + c)
        out.append(c0 * t_i + c1 * tfrac)
    return out


def _light_planes(
    albedo,  # [r, g, b, a] planes; a = specular mask (basic.frag:20-22)
    world,  # [x, y, z] planes
    normal,  # [x, y, z] planes
    camera_position,  # (3,) f32
    *,
    light_direction,
    light_color,
    ambient_amount: float,
    specular_power: float,
):
    """basic.frag:15-38 lighting, channel-planar. Returns [r, g, b]."""
    ldx, ldy, ldz = (jnp.float32(c) for c in light_direction)
    rn = _rnorm3(*normal)
    nx, ny, nz = normal[0] * rn, normal[1] * rn, normal[2] * rn
    vx = camera_position[0] - world[0]
    vy = camera_position[1] - world[1]
    vz = camera_position[2] - world[2]
    rv = _rnorm3(vx, vy, vz)
    vx, vy, vz = vx * rv, vy * rv, vz * rv

    n_dot_l = nx * ldx + ny * ldy + nz * ldz
    diffuse_amount = jnp.maximum(0.0, n_dot_l)
    # reflect(-l, n) = 2*(n.l)*n - l
    rx = 2.0 * n_dot_l * nx - ldx
    ry = 2.0 * n_dot_l * ny - ldy
    rz = 2.0 * n_dot_l * nz - ldz
    v_dot_r = jnp.maximum(0.0, vx * rx + vy * ry + vz * rz)
    spec_amount = albedo[3] * jnp.power(v_dot_r, specular_power)
    # Same association as basic.frag:36-38: (amb+diff)*lightColor*albedo
    # + spec*lightColor.
    k = ambient_amount + diffuse_amount
    lc = [jnp.float32(c) for c in light_color]
    return [(k * lc[i]) * albedo[i] + spec_amount * lc[i] for i in range(3)]


def blend_planes(rgb, src_alpha, mask, clear, mode: str = "alpha"):
    """Framebuffer blend stage (pipeline state, src/Renderer.zig:447-458).

    mode="alpha" is the reference's exact blend state:
      color: src*srcAlpha + dst*(1-srcAlpha), op add
      alpha: src*ZERO + dst*ONE  (the framebuffer keeps the clear alpha)
    Uncovered pixels keep dst (the clear color). The fragment stage
    outputs alpha 1.0 (basic.frag:38), so for the reference's opaque
    content this reduces to an opaque write — but the state exists and
    a translucent shader output blends against the destination exactly
    as wgpu would. mode="opaque" bypasses blending (select).

    dst here is the clear color: the visibility buffer resolves each
    pixel to ONE winning fragment before shading, so inter-fragment
    blending (translucency between overlapping draws) would need a
    multi-layer visibility pass — tracked as a limitation, same output
    for any opaque scene.
    """
    clear = [jnp.float32(c) for c in clear]
    if mode == "opaque":
        planes = [jnp.where(mask, rgb[i], clear[i]) for i in range(3)]
        return planes + [jnp.where(mask, jnp.float32(1.0), clear[3])]
    one_minus = jnp.float32(1.0) - src_alpha
    planes = [
        jnp.where(mask, rgb[i] * src_alpha + clear[i] * one_minus, clear[i])
        for i in range(3)
    ]
    # alpha: srcFactor ZERO, dstFactor ONE -> dst alpha everywhere.
    return planes + [jnp.broadcast_to(clear[3], mask.shape)]


def aniso_footprint(rho2_x, rho2_y, du_dx, du_dy, dv_dx, dv_dy, n: int):
    """Ratio-clamped anisotropic footprint (hardware-sampler semantics).

    Returns (rho2_used, maj_du, maj_dv, span):
      * rho2_used — the per-tap footprint: the minor axis, raised to
        rho2_max/n^2 when the anisotropy ratio exceeds n (the lod clamp
        hardware applies at maxAnisotropy);
      * maj_du/maj_dv — the full major-axis gradient (taps cover the
        whole footprint);
      * span — probe spread fraction (1 - 1/ratio): ISOTROPIC pixels get
        span 0, so all n probes coincide and the result is EXACTLY the
        single trilinear tap — no over-blur from fixed probe counts.

    Shared by the deferred shade and the resolve pass so the two paths
    stay bit-identical (same formulas, same op order).
    """
    rho2_max = jnp.maximum(rho2_x, rho2_y)
    rho2_min = jnp.minimum(rho2_x, rho2_y)
    rho2_used = jnp.maximum(rho2_min, rho2_max * jnp.float32(1.0 / (n * n)))
    ratio = jnp.sqrt(rho2_max / jnp.maximum(rho2_used, jnp.float32(1e-24)))
    ratio_c = jnp.clip(ratio, 1.0, jnp.float32(n))
    span = jnp.float32(1.0) - jnp.float32(1.0) / ratio_c
    major_is_x = rho2_x >= rho2_y
    maj_du = jnp.where(major_is_x, du_dx, du_dy)
    maj_dv = jnp.where(major_is_x, dv_dx, dv_dy)
    return rho2_used, maj_du, maj_dv, span


def probe_count(span, maj_du, maj_dv, tw0, th0, n: int):
    """Per-PIXEL probe count (f32) from the footprint's EFFECTIVE texel
    extent at the pixel's selected own mip level, clamped to [1, n].

    The probe train covers `span` of the major-axis gradient; its length
    at the selected level is (|maj_du|*span*tw0, |maj_dv|*span*th0)
    texels. ceil of the Chebyshev length spaces probes <= ~1.4 texels
    apart (hardware samplers take ~ratio taps of ~1-texel spacing). The
    abstract anisotropy RATIO alone over-counts wherever the lod clamp
    collapsed the footprint: at the mip-chain tail (tiny textures, deep
    minification) the whole probe train lands inside one texel and every
    probe returns the same bilinear. Isotropic pixels have span 0 and pay
    one probe.

    Shared by both shading paths, so they integrate the identical
    quadrature."""
    ext = jnp.maximum(jnp.abs(maj_du) * tw0, jnp.abs(maj_dv) * th0) * span
    return jnp.clip(
        jnp.ceil(ext - jnp.float32(1e-4)), 1.0, jnp.float32(n)
    )


def _plane_select(planes, lane):
    """planes (16, ...) selected at per-element level index (masked
    accumulation over the major axis)."""
    out = jnp.where(lane == 0, planes[0], 0)
    for i in range(1, 16):
        out = out + jnp.where(lane == i, planes[i], 0)
    return out


def shade_deferred(
    fid,  # (H, W) int32 face id, -1 background
    shade_rows,  # (F, 104) f32 packed per-face table (incl. tex info)
    texels,  # (N, 52) linear quad-row atlas
    camera_position,  # (3,) f32
    *,
    light_direction,
    light_color,
    ambient_amount: float,
    specular_power: float,
    clear_color,
    max_anisotropy: int = 1,
    y_offset=0,
    blend: str = "alpha",
    texel_format: str = "float",
):
    """Returns (4, H, W) f32 linear-color framebuffer (channel-planar).

    y_offset (scalar pixel rows, default 0): the sharded path shades its
    slab with GLOBAL pixel-row coordinates so slab output is
    bit-identical to the same rows of a single-chip frame.
    """
    h, w = fid.shape
    mask = fid >= 0
    f = jnp.maximum(fid, 0)

    # THE gather, then one transpose to channel-planar (104, H, W).
    rows = jnp.moveaxis(shade_rows[f], -1, 0)
    y0 = jnp.asarray(y_offset, jnp.float32)
    px = jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5 - rows[16]  # anchored
    py = jnp.arange(h, dtype=jnp.float32)[:, None] + y0 + 0.5 - rows[17]
    e0 = rows[0] * px + rows[1] * py + rows[2]
    e1 = rows[3] * px + rows[4] * py + rows[5]
    e2 = rows[6] * px + rows[7] * py + rows[8]
    esum = e0 + e1 + e2
    inv_esum = _safe_div(jnp.float32(1.0), esum)
    u0 = e0 * inv_esum
    u1 = e1 * inv_esum
    u2 = e2 * inv_esum

    def interp(base, k):  # scalar attribute k of a vec-k group at slots base..
        return u0 * rows[base] + u1 * rows[base + k] + u2 * rows[base + 2 * k]

    world = [interp(ROW_WORLD + i, 3) for i in range(3)]
    normal = [interp(ROW_NORMAL + i, 3) for i in range(3)]
    uv_u = interp(ROW_UV, 2)
    uv_v = interp(ROW_UV + 1, 2)

    # Analytic UV screen derivatives: uv = N(p)/D(p), N and D linear in p.
    a0, a1, a2 = rows[0], rows[3], rows[6]
    b0, b1, b2 = rows[1], rows[4], rows[7]
    d_x = a0 + a1 + a2
    d_y = b0 + b1 + b2
    inv2 = inv_esum * inv_esum

    def duv(c0, c1, c2):
        n = e0 * c0 + e1 * c1 + e2 * c2
        nx = a0 * c0 + a1 * c1 + a2 * c2
        ny = b0 * c0 + b1 * c1 + b2 * c2
        return (nx * esum - n * d_x) * inv2, (ny * esum - n * d_y) * inv2

    du_dx, du_dy = duv(rows[ROW_UV], rows[ROW_UV + 2], rows[ROW_UV + 4])
    dv_dx, dv_dy = duv(rows[ROW_UV + 1], rows[ROW_UV + 3], rows[ROW_UV + 5])

    # --- texture sampling -------------------------------------------------
    trow = jax.lax.bitcast_convert_type(
        rows[ROW_TEXINFO : ROW_TEXINFO + TEX_ROW_WIDTH], jnp.int32
    )  # (49, H, W)
    w0 = trow[16].astype(jnp.float32)
    h0 = trow[32].astype(jnp.float32)
    n_mips = trow[48]

    rho2_x = (du_dx * w0) ** 2 + (dv_dx * h0) ** 2
    rho2_y = (du_dy * w0) ** 2 + (dv_dy * h0) ** 2
    rho2_max = jnp.maximum(rho2_x, rho2_y)

    def level_fields(lvl):
        off = _plane_select(trow[0:16], lvl)
        tw = _plane_select(trow[16:32], lvl)
        th = _plane_select(trow[32:48], lvl)
        return off, tw, th

    def trilinear(u, v, rho2):
        lod = 0.5 * jnp.log2(jnp.maximum(rho2, 1e-24))
        lod = jnp.clip(lod, 0.0, (n_mips - 1).astype(jnp.float32))
        l0 = jnp.floor(lod).astype(jnp.int32)
        l1 = jnp.minimum(l0 + 1, n_mips - 1)
        tfrac = lod - l0.astype(jnp.float32)
        off0, tw0, th0 = level_fields(l0)
        _, tw1, th1 = level_fields(l1)
        return _trilerp(
            texels, off0, tw0, th0, tw1, th1, tfrac, u, v, texel_format
        )

    if max_anisotropy <= 1:
        albedo = trilinear(uv_u, uv_v, rho2_max)
    else:
        # Anisotropic filtering (the reference's sampler requests
        # maxAnisotropy 16, src/Renderer.zig:515): N trilinear probes
        # spaced along the major-axis gradient, ratio-clamped like a
        # hardware sampler (aniso_footprint): isotropic pixels' probes
        # coincide (== plain trilinear), ratios beyond N raise the tap
        # lod instead of under-sampling.
        n = int(max_anisotropy)
        rho2_used, maj_du, maj_dv, span = aniso_footprint(
            rho2_x, rho2_y, du_dx, du_dy, dv_dx, dv_dy, n
        )
        # Per-pixel probe count (probe_count): only pixels whose
        # footprint needs probe i contribute to it, and positions/
        # normalization use the pixel's own count. The own mip level's
        # dims give the effective extent (XLA CSEs this lod math with
        # trilinear()'s interior).
        lod_pc = jnp.clip(
            0.5 * jnp.log2(jnp.maximum(rho2_used, 1e-24)),
            0.0,
            (n_mips - 1).astype(jnp.float32),
        )
        _, tw0_pc, th0_pc = level_fields(jnp.floor(lod_pc).astype(jnp.int32))
        npx = probe_count(span, maj_du, maj_dv, tw0_pc, th0_pc, n)
        acc = [0.0, 0.0, 0.0, 0.0]
        for i in range(n):
            live = jnp.float32(i) < npx
            fo = ((jnp.float32(i) + 0.5) / npx - 0.5) * span
            probe = trilinear(uv_u + maj_du * fo, uv_v + maj_dv * fo, rho2_used)
            acc = [a + jnp.where(live, p, 0.0) for a, p in zip(acc, probe)]
        albedo = [a / npx for a in acc]

    rgb = _light_planes(
        albedo,
        world,
        normal,
        camera_position,
        light_direction=light_direction,
        light_color=light_color,
        ambient_amount=ambient_amount,
        specular_power=specular_power,
    )
    # Fragment output alpha is 1.0 (basic.frag:38); the blend stage is
    # still applied as real pipeline state (srcAlpha/1-srcAlpha + add,
    # alpha zero/one -- src/Renderer.zig:447-458).
    planes = blend_planes(rgb, jnp.float32(1.0), mask, clear_color, blend)
    return jnp.stack(planes, axis=0)


def shade_gbuffer(
    gbuf,  # (A_OUT, H, W) f32 from kernels/resolve.py
    texels,  # (N, 52) linear quad-row atlas
    camera_position,  # (3,) f32
    *,
    light_direction,
    light_color,
    ambient_amount: float,
    specular_power: float,
    clear_color,
    max_anisotropy: int = 1,
    blend: str = "alpha",
    texel_format: str = "float",
):
    """Forward-path shading tail: the resolve pass already interpolated
    everything per pixel, so this is just texture taps (the only remaining
    gathers: one 52-float quad row per trilinear sample) + the basic.frag
    lighting — same formulas and op order as shade_deferred so the two
    paths match bit-for-bit. Everything is channel-planar over (H, W)
    pixel planes, in framebuffer layout end to end.

    Returns (4, H, W) f32 linear-color planes.
    """

    def g(i):
        return gbuf[i]  # (H, W)

    mask = g(16) > 0.0
    world = [g(0), g(1), g(2)]
    normal = [g(3), g(4), g(5)]
    uv_u, uv_v = g(6), g(7)
    # Offsets rode through f32 as offset/256 (exact); widths/heights are
    # small integers in f32.
    off0 = g(8).astype(jnp.int32) * 256
    tw0 = g(9).astype(jnp.int32)
    th0 = g(10).astype(jnp.int32)
    tw1 = g(11).astype(jnp.int32)
    th1 = g(12).astype(jnp.int32)
    tfrac = g(13)
    maj_du, maj_dv = g(14), g(15)
    span = g(17)  # probe spread fraction from aniso_footprint (resolve)

    def trilinear_at(u, v):
        return _trilerp(
            texels, off0, tw0, th0, tw1, th1, tfrac, u, v, texel_format
        )

    if max_anisotropy <= 1:
        albedo = trilinear_at(uv_u, uv_v)
    else:
        n_probes = int(max_anisotropy)
        # Per-pixel probe counts — see probe_count / shade_deferred.
        npx = probe_count(
            span, maj_du, maj_dv, g(9), g(10), n_probes
        )
        acc = [0.0, 0.0, 0.0, 0.0]
        for i in range(n_probes):
            live = jnp.float32(i) < npx
            fo = ((jnp.float32(i) + 0.5) / npx - 0.5) * span
            probe = trilinear_at(uv_u + maj_du * fo, uv_v + maj_dv * fo)
            acc = [a + jnp.where(live, p, 0.0) for a, p in zip(acc, probe)]
        albedo = [a / npx for a in acc]

    rgb = _light_planes(
        albedo,
        world,
        normal,
        camera_position,
        light_direction=light_direction,
        light_color=light_color,
        ambient_amount=ambient_amount,
        specular_power=specular_power,
    )
    # Fragment output alpha is 1.0 (basic.frag:38); the blend stage is
    # still applied as real pipeline state (srcAlpha/1-srcAlpha + add,
    # alpha zero/one -- src/Renderer.zig:447-458).
    planes = blend_planes(rgb, jnp.float32(1.0), mask, clear_color, blend)
    return jnp.stack(planes, axis=0)  # (4, H, W)
