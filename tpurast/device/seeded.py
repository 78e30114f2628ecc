"""Seeded demo-class scenes: the reference's scene shapes, generated.

The reference demo scene (src/Engine.zig:110-141) is arena.glb + the
Stanford dragon + crate.glb. Those assets are not part of this
repository, so these loaders rebuild their SHAPES from a seed and run
them through the same build_scene path as loaded glTF models:

  * arena — 10 triangles: an 8x8 floor and four inward-facing walls,
    bound to the fallback texture (the reference's arena samples the
    embedded checker);
  * crate — 12 triangles (a cube), a 512^2 BC7-sRGB texture with a full
    mip chain, placed like the reference (scale 0.4, -1.4 up);
  * dragon-class mesh — exactly 19,332 triangles over 11,340 vertices
    (the dragon: 19,332 / 11,319), a closed seeded-displaced torus in
    nine UV strips (the strip seams duplicate vertices like a real
    mesh's UV seams), scaled to the mounted dragon's bounds and placed
    at -1 up on the crate; a 2048^2 BC7-sRGB texture with a full mip
    chain and the specular mask in alpha (SURVEY §2.4.4).

Textures are encoded to BC7 (mode 6) and wrapped as in-memory KTX2 blobs
without supercompression, so the BC7 decoders stay on the load path.

load_seeded_hdr_scene rebuilds BASELINE config #3 the same way: two
crates with BC6H-UF16 textures at the shipped assets' shapes (512^2 with
one mip — HDR radiances up to 65504 — and 128^2 with a full chain) over
a floor with a generated BC4u map.

Everything is a pure function of the seed.
"""

from __future__ import annotations

import numpy as np

from tpurast import math3d
from tpurast.assets.gltf import GltfModel, PrimitiveDraw
from tpurast.assets.ktx2_write import make_bc4_ktx2, make_bc6h_ktx2, make_bc7_ktx2
from tpurast.device.scene import build_scene, grid_transforms, quad_draw, replicate_model

#: Dragon-class mesh grid: 179 x 54 quads -> 19,332 triangles; the 54
#: minor-axis quads split into 9 strips of 6 (11,340 vertices).
DRAGON_MAJOR = 179
DRAGON_MINOR = 54
DRAGON_STRIPS = 9
#: Mounted dragon's model-space extent (x, up, z); its height is 0.0996.
DRAGON_EXTENT = np.array([0.14, 0.0996, 0.063], np.float32)

CRATE_URI = "mem://crate_diffuse_specular_bc7.ktx2"
DRAGON_URI = "mem://dragon_diffuse_specular_bc7.ktx2"
HDR_URI = "mem://hdr_bc6u.ktx2"
HDR_MIPS_URI = "mem://missing_bc6u.ktx2"
BC4_URI = "mem://bc4_stripes.ktx2"


def _orient(positions: np.ndarray, tris: np.ndarray, outward: np.ndarray) -> np.ndarray:
    """Flip triangles so cross(v1-v0, v2-v0) points along `outward`
    (per-triangle (T, 3)): the front-facing (CCW) winding of this
    renderer's y-down framebuffer, as geometry.triangle_setup culls."""
    v0, v1, v2 = (positions[tris[:, k]] for k in range(3))
    flip = (np.cross(v1 - v0, v2 - v0) * outward).sum(axis=1) < 0
    tris = tris.copy()
    tris[flip, 1], tris[flip, 2] = tris[flip, 2], tris[flip, 1].copy()
    return tris


def _draw(positions, normals, uvs, tris, image_uri, name, model=None) -> PrimitiveDraw:
    model = math3d.mat4_identity() if model is None else model
    return PrimitiveDraw(
        positions=positions.astype(np.float32),
        normals=normals.astype(np.float32),
        uvs=uvs.astype(np.float32),
        indices=tris.reshape(-1).astype(np.uint32),
        model_matrix=model.astype(np.float32),
        normal_matrix=math3d.normal_matrix(model).astype(np.float32),
        image_uri=image_uri,
        material_name="seeded",
        node_name=name,
    )


def _box_faces(lo, hi, inward: bool):
    """The six quads of an axis-aligned box as (positions, normals, uvs,
    tris), four vertices per quad (flat normals); quad q is triangles
    2q and 2q+1."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    pos, nrm, uv, tris = [], [], [], []
    for axis in range(3):
        for side in (0, 1):
            n = np.zeros(3, np.float32)
            n[axis] = 1.0 if side else -1.0
            a, b = [d for d in range(3) if d != axis]
            corners = []
            for ca, cb in ((0, 0), (1, 0), (1, 1), (0, 1)):
                p = np.empty(3, np.float32)
                p[axis] = hi[axis] if side else lo[axis]
                p[a] = hi[a] if ca else lo[a]
                p[b] = hi[b] if cb else lo[b]
                corners.append(p)
            base = len(pos)
            pos.extend(corners)
            nn = -n if inward else n
            nrm.extend([nn] * 4)
            uv.extend([(0, 0), (1, 0), (1, 1), (0, 1)])
            tris.extend([(base, base + 1, base + 2), (base, base + 2, base + 3)])
    return (
        np.asarray(pos),
        np.asarray(nrm),
        np.asarray(uv, np.float32),
        np.asarray(tris, np.int64),
    )


def arena_draw() -> PrimitiveDraw:
    """10 triangles: floor (y = 1.8, world up is -Y) + 4 walls 1.2 high,
    all facing the inside of an 8 x 8 arena."""
    pos, nrm, uv, tris = _box_faces((-4.0, 0.6, -4.0), (4.0, 1.8, 4.0), inward=True)
    keep = []
    for q in range(6):
        # Drop the ceiling quad (the y = 0.6 face): the arena is open.
        if not (np.allclose(pos[4 * q : 4 * q + 4, 1], 0.6)):
            keep.extend([2 * q, 2 * q + 1])
    tris = _orient(pos, tris[keep], nrm[tris[keep][:, 0]])
    uv = uv * 8.0  # the checker repeats across the floor/walls
    return _draw(pos, nrm, uv, tris, None, "arena")


def crate_draw(image_uri: str = CRATE_URI, offset=(0.0, 0.0, 0.0)) -> PrimitiveDraw:
    """12 triangles: cube [-1, 1]^3 at the crate placement (+ offset)."""
    pos, nrm, uv, tris = _box_faces((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), inward=False)
    tris = _orient(pos, tris, nrm[tris[:, 0]])
    up = math3d.WORLD_SPACE.up.vector()
    # scaleUniform(translate(I, up*-1.4), 0.4): scale applied first.
    model = math3d.compose(
        math3d.scaling(0.4),
        math3d.translation(up * -1.4 + np.asarray(offset, np.float32)),
    )
    return _draw(pos, nrm, uv, tris, image_uri, "crate", model)


def dragon_mesh(rng: np.random.Generator):
    """(positions, normals, uvs, tris) of the dragon-class mesh in world
    orientation (up = -Y), resting on y = 0 and centred in x/z."""
    nu, nv = DRAGON_MAJOR, DRAGON_MINOR
    th = np.linspace(0.0, 2 * np.pi, nu + 1)[:, None]  # (nu+1, 1), row nu == row 0
    ph = np.linspace(0.0, 2 * np.pi, nv + 1)[None, :]  # (1, nv+1)
    disp = np.ones((nu + 1, nv + 1))
    for _ in range(6):
        m, k = rng.integers(1, 6), rng.integers(0, 4)
        amp, phase = rng.uniform(0.03, 0.12), rng.uniform(0, 2 * np.pi)
        disp = disp + amp * np.sin(m * th + k * ph + phase)
    major, minor = 1.0, 0.42 * disp
    ring = major + minor * np.cos(ph)
    p = np.stack([ring * np.cos(th), minor * np.sin(ph), ring * np.sin(th)], axis=-1)
    # Smooth normals from the periodic parameter grid (seam-consistent).
    core = p[:-1, :-1]
    d_th = np.roll(core, -1, 0) - np.roll(core, 1, 0)
    d_ph = np.roll(core, -1, 1) - np.roll(core, 1, 1)
    n = np.cross(d_th, d_ph)
    centre = np.stack([np.cos(th[:-1]) * major, 0 * th[:-1], np.sin(th[:-1]) * major], -1)
    n = np.where(((n * (core - centre)).sum(-1) < 0)[..., None], -n, n)
    n = np.concatenate([n, n[:, :1]], axis=1)
    n = np.concatenate([n, n[:1]], axis=0)  # (nu+1, nv+1, 3)

    # Scale to the dragon's bounds; world up is -Y, so the model rests on
    # y = 0 and extends to negative y.
    flat = p.reshape(-1, 3)
    lo, hi = flat.min(0), flat.max(0)
    scale = DRAGON_EXTENT / (hi - lo)
    p = (p - (lo + hi) / 2) * scale
    p[..., 1] = -(p[..., 1] + DRAGON_EXTENT[1] / 2)
    n = n / scale
    n[..., 1] = -n[..., 1]
    n /= np.linalg.norm(n, axis=-1, keepdims=True)

    pos, nrm, uv, tris = [], [], [], []
    width = nv // DRAGON_STRIPS
    iu = np.arange(nu + 1)[:, None]
    for s in range(DRAGON_STRIPS):
        cols = np.arange(s * width, (s + 1) * width + 1)
        base = sum(len(a) for a in pos)
        pos.append(p[:, cols].reshape(-1, 3))
        nrm.append(n[:, cols].reshape(-1, 3))
        uu = np.broadcast_to(cols[None, :] * (2.0 / nv), (nu + 1, len(cols)))
        vv = np.broadcast_to(iu * (6.0 / nu), (nu + 1, len(cols)))
        uv.append(np.stack([uu, vv], -1).reshape(-1, 2))
        c = len(cols)
        i, j = np.meshgrid(np.arange(nu), np.arange(width), indexing="ij")
        v00 = base + i * c + j
        v01, v10, v11 = v00 + 1, v00 + c, v00 + c + 1
        quads = np.stack([v00, v10, v11, v01], -1).reshape(-1, 4)
        tris.append(np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]]))
    pos, nrm, uv = np.concatenate(pos), np.concatenate(nrm), np.concatenate(uv)
    tris = np.concatenate(tris)
    outward = nrm[tris].sum(axis=1)
    return pos, nrm, uv, _orient(pos, tris, outward)


def _smooth_field(rng, size: int, cells: int, channels: int) -> np.ndarray:
    """(size, size, channels) f32 in [0, 1]: a random (cells+1)^2 grid
    bilinearly upsampled (repeat-friendly low-frequency content)."""
    grid = rng.random((cells + 1, cells + 1, channels)).astype(np.float32)
    grid[-1] = grid[0]
    grid[:, -1] = grid[:, 0]
    x = np.arange(size, dtype=np.float32) * (cells / size)
    i0 = x.astype(np.int32)
    f = (x - i0)[:, None, None]
    rows = grid[i0] * (1 - f) + grid[i0 + 1] * f  # (size, cells+1, C)
    f2 = f[:, 0][None, :, :]
    return rows[:, i0] * (1 - f2) + rows[:, i0 + 1] * f2


def seeded_texture(rng, size: int, tint, cells: int = 16) -> np.ndarray:
    """(size, size, 4) u8 sRGB albedo with a specular mask in alpha."""
    field = _smooth_field(rng, size, cells, 4)
    grain = rng.integers(-10, 11, (size, size, 4), dtype=np.int16)
    rgb = 255.0 * np.asarray(tint, np.float32) * (0.55 + 0.45 * field[..., :3])
    spec = 255.0 * (0.15 + 0.8 * field[..., 3:])
    img = np.concatenate([rgb, spec], axis=-1) + grain
    return np.clip(img, 0, 255).astype(np.uint8)


def _texture_assets(rng, dragon_texture_size: int) -> dict[str, bytes]:
    crate = seeded_texture(rng, 512, (0.62, 0.43, 0.25))
    dragon = seeded_texture(rng, dragon_texture_size, (0.35, 0.6, 0.3), cells=32)
    return {CRATE_URI: make_bc7_ktx2(crate), DRAGON_URI: make_bc7_ktx2(dragon)}


def _dragon_model(rng) -> GltfModel:
    pos, nrm, uv, tris = dragon_mesh(rng)
    up = math3d.WORLD_SPACE.up.vector()
    draw = _draw(pos, nrm, uv, tris, DRAGON_URI, "dragon", math3d.translation(up * -1.0))
    return GltfModel(draws=[draw], image_uris=[DRAGON_URI])


def load_seeded_demo_scene(seed: int = 0, dragon_texture_size: int = 2048):
    """The demo scene's shapes from `seed`: arena + dragon-class mesh +
    crate, 19,354 triangles (the reference demo without the Porsche)."""
    rng = np.random.default_rng(seed)
    dragon = _dragon_model(rng)
    assets = _texture_assets(rng, dragon_texture_size)
    models = [
        GltfModel(draws=[arena_draw()], image_uris=[]),
        dragon,
        GltfModel(draws=[crate_draw()], image_uris=[CRATE_URI]),
    ]
    return build_scene(models, memory_assets=assets)


def load_seeded_dragons(
    seed: int = 0, count: int = 64, spacing: float = 0.35, dragon_texture_size: int = 2048
):
    """BASELINE config #4 from `seed`: the dragon-class mesh x `count` in
    a grid (default 8x8), sharing one texture."""
    rng = np.random.default_rng(seed)
    dragon = _dragon_model(rng)
    assets = _texture_assets(rng, dragon_texture_size)
    model = replicate_model(dragon, grid_transforms(count, spacing))
    return build_scene([model], memory_assets=assets)


def _hdr_radiance(rng, size: int) -> np.ndarray:
    """(size, size, 3) f32 HDR radiance, 2^-4 .. ~2^16 (clamped to the
    half-float max 65504)."""
    field = _smooth_field(rng, size, 8, 3)
    return np.minimum(np.exp2(field * 20.0 - 4.0), 65504.0).astype(np.float32)


def load_seeded_hdr_scene(seed: int = 0):
    """BASELINE config #3 from `seed`: BC6H HDR crates + BC4u floor."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:256, 0:256]
    stripes = (((x // 8) % 2) * 220 + 20).astype(np.uint8)
    assets = {
        HDR_URI: make_bc6h_ktx2(_hdr_radiance(rng, 512), full_chain=False),
        HDR_MIPS_URI: make_bc6h_ktx2(_hdr_radiance(rng, 128)),
        BC4_URI: make_bc4_ktx2(stripes, supercompress=False),
    }
    models = [
        GltfModel(draws=[quad_draw((0.0, 0.0), 8.0, 8.0, 1.8, 8.0, BC4_URI)], image_uris=[BC4_URI]),
        GltfModel(draws=[crate_draw(HDR_URI)], image_uris=[HDR_URI]),
        GltfModel(draws=[crate_draw(HDR_MIPS_URI, (1.0, 0.0, 0.0))], image_uris=[HDR_MIPS_URI]),
    ]
    return build_scene(models, memory_assets=assets)
