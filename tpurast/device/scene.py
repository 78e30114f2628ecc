"""Scene geometry residency: flat, padded, device-ready draw buffers.

The reference keeps per-primitive vertex/index/uniform buffers and walks
them in a CPU loop of bind+draw calls (src/Renderer.zig:1034-1072). Here
every primitive of every model is concatenated into one set of arrays so
a frame is ONE batched vertex transform + raster, with a per-face
primitive id carrying the material/transform binding.

Instancing (BASELINE config #4) is primitive replication at build time:
the reference always draws instanceCount=1 (src/Renderer.zig:1069), and
instance transforms here become additional primitive records sharing the
same vertex range.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np

from tpurast.assets.gltf import GltfModel, PrimitiveDraw, load_glb
from tpurast.assets.ktx2 import load_ktx2
from tpurast.device import textures as tex_mod

log = logging.getLogger("tpurast.device")


def _pad_to(arr: np.ndarray, n: int, fill=0) -> np.ndarray:
    pad = n - arr.shape[0]
    if pad <= 0:
        return arr
    pad_block = np.full((pad,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad_block], axis=0)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class DeviceScene:
    """Host-staged scene; `.device()` returns the jnp pytree for the frame
    function. All array sizes are padded to static shapes."""

    positions: np.ndarray  # (Vp, 3) f32, model space
    normals: np.ndarray  # (Vp, 3) f32, model space
    uvs: np.ndarray  # (Vp, 2) f32
    vert_prim: np.ndarray  # (Vp,) i32
    faces: np.ndarray  # (Fp, 3) i32, global vertex indices
    face_prim: np.ndarray  # (Fp,) i32
    n_faces: int
    n_vertices: int
    models: np.ndarray  # (P, 4, 4) f32
    normal_mats: np.ndarray  # (P, 3, 3) f32
    prim_tex: np.ndarray  # (P,) i32 texture id (0 = fallback)
    atlas: tex_mod.TextureAtlas
    texture_uris: list[str]
    # Build-time face-corner tables (world space). The model->world half
    # of the vertex stage plus ALL vertex->face gathers run once here:
    # per frame the geometry stage is pure arithmetic over (Fp, 3, ...)
    # corner rows (kernels/geometry.transform_corners).
    corner_world: np.ndarray | None = None  # (Fp, 3, 3) f32
    corner_normal: np.ndarray | None = None  # (Fp, 3, 3) f32
    corner_uv: np.ndarray | None = None  # (Fp, 3, 2) f32
    face_tex: np.ndarray | None = None  # (Fp,) i32 = prim_tex[face_prim]

    @property
    def triangle_count(self) -> int:
        return self.n_faces

    def device(self, texture_dtype: str = "float16"):
        import jax.numpy as jnp

        # Memoized per dtype: atlas conversion/upload is the expensive
        # part (minutes for multi-GB srgb8 encodes) and every Renderer
        # ctor calls device().
        cache = self.__dict__.setdefault("_device_cache", {})
        if texture_dtype in cache:
            return cache[texture_dtype]
        cache[texture_dtype] = out = {
            "positions": jnp.asarray(self.positions),
            "normals": jnp.asarray(self.normals),
            "uvs": jnp.asarray(self.uvs),
            "vert_prim": jnp.asarray(self.vert_prim),
            "faces": jnp.asarray(self.faces),
            "face_prim": jnp.asarray(self.face_prim),
            "n_faces": jnp.int32(self.n_faces),
            "models": jnp.asarray(self.models),
            "normal_mats": jnp.asarray(self.normal_mats),
            "prim_tex": jnp.asarray(self.prim_tex),
            "atlas": self.atlas.device(texture_dtype),
            "corner_world": jnp.asarray(self.corner_tables()[0]),
            "corner_normal": jnp.asarray(self.corner_tables()[1]),
            "corner_uv": jnp.asarray(self.corner_tables()[2]),
            "face_tex": jnp.asarray(
                self.face_tex
                if self.face_tex is not None
                else self.prim_tex[self.face_prim]
            ),
        }
        return out

    def corner_tables(self):
        """World-space face-corner tables, computed once (host).

        Runs basic.vert's model->world half (world = model * pos, normal
        via the 3x3 normal matrix, src/Renderer.zig:797-807 transforms
        are static per scene) and bakes the vertex->face indirection, so
        the per-frame vertex stage has zero dynamic gathers."""
        if self.corner_world is None:
            m = self.models[self.vert_prim]  # (Vp, 4, 4)
            ph = np.concatenate(
                [self.positions, np.ones_like(self.positions[:, :1])], axis=1
            )
            world = np.einsum("vij,vj->vi", m, ph).astype(np.float32)[:, :3]
            nm = self.normal_mats[self.vert_prim]
            wnormal = np.einsum("vij,vj->vi", nm, self.normals).astype(np.float32)
            self.corner_world = world[self.faces]
            self.corner_normal = wnormal[self.faces]
            self.corner_uv = self.uvs[self.faces]
        return self.corner_world, self.corner_normal, self.corner_uv


def build_scene(
    models: list[GltfModel],
    data_dir: str | os.PathLike | None = None,
    face_pad: int = 256,
    vert_pad: int = 128,
    memory_assets: dict[str, bytes] | None = None,
) -> DeviceScene:
    """Assemble parsed models into flat device buffers + texture atlas.

    ``data_dir`` resolves image URIs (the reference resolves them against
    its data dir and caches by URI, src/Renderer.zig:689-699); missing
    files bind the fallback texture (texture id 0), mirroring
    src/Renderer.zig:724-746. ``memory_assets`` maps ``mem://`` URIs to
    KTX2 blobs (generated fixtures, e.g. BC4 monochrome maps).
    """
    from tpurast.assets.ktx2 import parse_ktx2

    draws: list[PrimitiveDraw] = [d for m in models for d in m.draws]

    # Texture registry: id 0 is the fallback; others keyed by URI.
    uri_to_id: dict[str, int] = {}
    pyramids: list[list[np.ndarray]] = [tex_mod.fallback_texture(data_dir)]
    texture_uris = ["builtin://fallback-texture"]  # src/Renderer.zig:551-557

    def texture_id(uri: str | None) -> int:
        if uri is None:
            return 0
        if uri in uri_to_id:
            return uri_to_id[uri]
        if memory_assets is not None and uri in memory_assets:
            ktx = parse_ktx2(memory_assets[uri])
            pyramids.append(tex_mod.decode_ktx2_texture(ktx))
            tid = len(pyramids) - 1
            uri_to_id[uri] = tid
            texture_uris.append(uri)
            return tid
        path = os.path.join(data_dir, uri) if data_dir is not None else uri
        if not os.path.exists(path):
            log.error("failed to find texture: %s", uri)
            uri_to_id[uri] = 0
            return 0
        ktx = load_ktx2(path)
        pyramids.append(tex_mod.decode_ktx2_texture(ktx))
        tid = len(pyramids) - 1
        uri_to_id[uri] = tid
        texture_uris.append(uri)
        log.debug("texture %d: %s (%s %dx%d, %d mips)", tid, uri, ktx.format_name, ktx.width, ktx.height, ktx.level_count)
        return tid

    positions, normals, uvs, vert_prim = [], [], [], []
    faces, face_prim = [], []
    prim_models, prim_normal_mats, prim_tex = [], [], []
    v_cursor = 0
    for pid, d in enumerate(draws):
        nv = d.positions.shape[0]
        positions.append(d.positions.astype(np.float32))
        normals.append(d.normals.astype(np.float32))
        uvs.append(d.uvs.astype(np.float32))
        vert_prim.append(np.full(nv, pid, dtype=np.int32))
        faces.append(d.indices.astype(np.int64).reshape(-1, 3).astype(np.int32) + v_cursor)
        face_prim.append(np.full(len(d.indices) // 3, pid, dtype=np.int32))
        prim_models.append(d.model_matrix.astype(np.float32))
        prim_normal_mats.append(d.normal_matrix.astype(np.float32))
        prim_tex.append(texture_id(d.image_uri))
        v_cursor += nv

    pos = np.concatenate(positions) if positions else np.zeros((0, 3), np.float32)
    nrm = np.concatenate(normals) if normals else np.zeros((0, 3), np.float32)
    uv = np.concatenate(uvs) if uvs else np.zeros((0, 2), np.float32)
    vp = np.concatenate(vert_prim) if vert_prim else np.zeros(0, np.int32)
    fc = np.concatenate(faces) if faces else np.zeros((0, 3), np.int32)
    fp = np.concatenate(face_prim) if face_prim else np.zeros(0, np.int32)

    n_faces = fc.shape[0]
    n_vertices = pos.shape[0]
    fpad = max(face_pad, _round_up(n_faces, face_pad))
    vpad = max(vert_pad, _round_up(n_vertices, vert_pad))

    faces_padded = _pad_to(fc, fpad)
    prim_tex_arr = np.asarray(prim_tex if prim_tex else [0], dtype=np.int32)
    face_prim_padded = _pad_to(fp, fpad)
    scene = DeviceScene(
        positions=_pad_to(pos, vpad),
        normals=_pad_to(nrm, vpad),
        uvs=_pad_to(uv, vpad),
        vert_prim=_pad_to(vp, vpad),
        faces=faces_padded,
        face_prim=face_prim_padded,
        n_faces=n_faces,
        n_vertices=n_vertices,
        models=np.stack(prim_models) if prim_models else np.eye(4, dtype=np.float32)[None],
        normal_mats=np.stack(prim_normal_mats) if prim_normal_mats else np.eye(3, dtype=np.float32)[None],
        prim_tex=prim_tex_arr,
        atlas=tex_mod.build_atlas(pyramids),
        texture_uris=texture_uris,
        face_tex=prim_tex_arr[face_prim_padded],
    )
    scene.corner_tables()
    return scene


def replicate_model(model: GltfModel, transforms: list[np.ndarray]) -> GltfModel:
    """Instancing: one draw record per instance transform.

    The reference always draws instanceCount=1 (src/Renderer.zig:1069);
    BASELINE config #4 (dragon x64) extends this. Instances share the
    source arrays (no vertex copy on host); the flat scene build emits a
    primitive record per instance, so the batched vertex transform treats
    instances like any other primitive.
    """
    from tpurast import math3d

    draws = []
    for t in transforms:
        for d in model.draws:
            draws.append(
                dataclasses.replace(
                    d,
                    model_matrix=math3d.compose(d.model_matrix, t),
                    normal_matrix=math3d.normal_matrix(
                        math3d.compose(d.model_matrix, t)
                    ),
                )
            )
    return GltfModel(draws=draws, image_uris=model.image_uris)


def grid_transforms(count: int, spacing: float) -> list[np.ndarray]:
    """Instance translations on a square x/z grid (BASELINE config #4)."""
    from tpurast import math3d

    side = int(np.ceil(np.sqrt(count)))
    transforms = []
    for i in range(count):
        gx, gz = i % side, i // side
        offs = np.array(
            [(gx - (side - 1) / 2) * spacing, 0.0, (gz - (side - 1) / 2) * spacing],
            dtype=np.float32,
        )
        transforms.append(math3d.translation(offs))
    return transforms


def load_instanced_dragons(data_dir: str, count: int = 64, spacing: float = 0.35) -> DeviceScene:
    """BASELINE config #4 scene: dragon x N in a grid (default 8x8)."""
    from tpurast import math3d

    up = math3d.WORLD_SPACE.up.vector()
    dragon = load_glb(
        os.path.join(data_dir, "meshes/stanford_dragon.glb"),
        post_transform=math3d.translation(up * -1.0),
    )
    model = replicate_model(dragon, grid_transforms(count, spacing))
    return build_scene([model], data_dir=data_dir)


def quad_draw(
    center, size_x, size_z, y, uv_scale, image_uri, normal_up=True
) -> PrimitiveDraw:
    """Procedural textured floor/ceiling quad (world-space verts)."""
    from tpurast import math3d

    hx, hz = size_x / 2, size_z / 2
    cx, cz = center
    positions = np.array(
        [
            [cx - hx, y, cz - hz],
            [cx + hx, y, cz - hz],
            [cx + hx, y, cz + hz],
            [cx - hx, y, cz + hz],
        ],
        dtype=np.float32,
    )
    n = np.array([0.0, -1.0 if normal_up else 1.0, 0.0], dtype=np.float32)
    # Winding: front-facing (CCW in y-down framebuffer coords) when seen
    # from the -Y (up) side.
    indices = np.array([0, 1, 2, 0, 2, 3] if normal_up else [0, 2, 1, 0, 3, 2], np.uint32)
    uvs = np.array([[0, 0], [uv_scale, 0], [uv_scale, uv_scale], [0, uv_scale]], np.float32)
    return PrimitiveDraw(
        positions=positions,
        normals=np.broadcast_to(n, (4, 3)).copy(),
        uvs=uvs,
        indices=indices,
        model_matrix=math3d.mat4_identity(),
        normal_matrix=np.eye(3, dtype=np.float32),
        image_uri=image_uri,
        material_name="procedural",
        node_name="quad",
    )


def load_hdr_scene(data_dir: str) -> DeviceScene:
    """BASELINE config #3: BC6H HDR base color + BC4u monochrome maps,
    full mip chains, trilinear.

    Geometry: two crates textured with the shipped BC6H assets
    (hdr_bc6u: true HDR radiances up to 65504; missing_bc6u: 8-mip
    chain) over a floor quad textured with a GENERATED BC4u KTX2
    (tpurast.assets.ktx2_write — the reference has the BC4 code path,
    src/wgpu.zig:137, but ships no asset)."""
    import dataclasses as _dc

    from tpurast import math3d
    from tpurast.assets.ktx2_write import make_bc4_ktx2

    up = math3d.WORLD_SPACE.up.vector()
    crate = load_glb(
        os.path.join(data_dir, "meshes/crate.glb"),
        post_transform=math3d.compose(math3d.scaling(0.4), math3d.translation(up * -1.4)),
    )
    crate_hdr = GltfModel(
        draws=[_dc.replace(d, image_uri="textures/hdr_bc6u.ktx2") for d in crate.draws],
        image_uris=["textures/hdr_bc6u.ktx2"],
    )
    crate2 = load_glb(
        os.path.join(data_dir, "meshes/crate.glb"),
        post_transform=math3d.compose(
            math3d.scaling(0.4), math3d.translation(up * -1.4 + np.array([1.0, 0, 0]))
        ),
    )
    crate_mips = GltfModel(
        draws=[_dc.replace(d, image_uri="textures/missing_bc6u.ktx2") for d in crate2.draws],
        image_uris=["textures/missing_bc6u.ktx2"],
    )
    # Generated BC4u stripes (full mip chain exercises trilinear).
    y, x = np.mgrid[0:256, 0:256]
    stripes = (((x // 8) % 2) * 220 + 20).astype(np.uint8)
    bc4_blob = make_bc4_ktx2(stripes)
    floor = GltfModel(
        draws=[quad_draw((0.0, 0.0), 8.0, 8.0, 1.8, 8.0, "mem://bc4_stripes.ktx2")],
        image_uris=["mem://bc4_stripes.ktx2"],
    )
    return build_scene(
        [floor, crate_hdr, crate_mips],
        data_dir=data_dir,
        memory_assets={"mem://bc4_stripes.ktx2": bc4_blob},
    )


def load_porsche_class_scene(data_dir: str, max_textures: int = 11) -> DeviceScene:
    """BASELINE config #2 stand-in: porche.glb is stripped from the mount
    (.MISSING_LARGE_BLOBS), but its BC7 textures shipped. This scene
    exercises the multi-material / high-res-texture path the Porsche
    would: dragons + crates, each draw bound to a different Porsche
    2048x2048 BC7 texture (full mip chains), arena around them.

    When porche.glb is present, load_demo_scene picks it up instead.
    """
    import glob as _glob

    from tpurast import math3d

    up = math3d.WORLD_SPACE.up.vector()
    uris = sorted(
        os.path.relpath(p, data_dir)
        for p in _glob.glob(os.path.join(data_dir, "textures/porche/*.ktx2"))
    )[:max_textures]
    if not uris:
        raise FileNotFoundError("no porsche textures in data dir")

    arena = load_glb(os.path.join(data_dir, "meshes/arena.glb"))
    dragon = load_glb(os.path.join(data_dir, "meshes/stanford_dragon.glb"))
    crate = load_glb(os.path.join(data_dir, "meshes/crate.glb"))
    models = [arena]
    for i, uri in enumerate(uris):
        src = dragon if i % 2 == 0 else crate
        gx, gz = i % 4, i // 4
        post = math3d.compose(
            math3d.scaling(2.0 if src is dragon else 0.25),
            math3d.translation(
                np.array([(gx - 1.5) * 0.8, 1.0 if src is dragon else 1.25, (gz - 1.0) * 0.8], np.float32)
            ),
        )
        draws = [
            dataclasses.replace(
                d,
                image_uri=uri,
                model_matrix=math3d.compose(d.model_matrix, post),
                normal_matrix=math3d.normal_matrix(math3d.compose(d.model_matrix, post)),
            )
            for d in src.draws
        ]
        models.append(GltfModel(draws=draws, image_uris=[uri]))
    return build_scene(models, data_dir=data_dir)


def load_demo_scene(data_dir: str, include_porsche: bool = True) -> DeviceScene:
    """The reference's 4-model demo scene (src/Engine.zig:110-141).

    A mesh missing from the data dir (porche.glb is often absent) is
    skipped with a log line; a data dir with none of them raises.
    """
    from tpurast import math3d

    up = math3d.WORLD_SPACE.up.vector()
    fwd = math3d.WORLD_SPACE.forward.vector()
    placements = [
        ("meshes/arena.glb", math3d.mat4_identity()),
        ("meshes/stanford_dragon.glb", math3d.translation(up * -1.0)),
        (
            "meshes/crate.glb",
            # scaleUniform(translate(I, up*-1.4), 0.4): scale applied first.
            math3d.compose(math3d.scaling(0.4), math3d.translation(up * -1.4)),
        ),
    ]
    if include_porsche:
        placements.append(
            (
                "meshes/porche.glb",
                # rotateAxis(translate(I, fwd*2 + up*-1.95), 90deg, up):
                # rotation applied first (cglm post-multiply).
                math3d.compose(
                    math3d.rotation_axis(np.deg2rad(90.0), up),
                    math3d.translation(fwd * 2.0 + up * -1.95),
                ),
            )
        )
    models = []
    for rel, post in placements:
        path = os.path.join(data_dir, rel)
        if not os.path.exists(path):
            log.warning("%s missing from data dir (stripped blob?) — skipped", rel)
            continue
        models.append(load_glb(path, post_transform=post))
    if not models:
        raise FileNotFoundError(f"no demo meshes under {data_dir}")
    return build_scene(models, data_dir=data_dir)
