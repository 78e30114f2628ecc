"""Texture mip atlas: device layout + host-side build.

All scene textures (decoded from KTX2/BC on host, see tpurast.assets) are
packed into one flat (N, 4) float32 array of linear-color texels. Small
side tables give per-(texture, mip) offsets and sizes. The sampling kernel
(kernels/shade.py) computes flat indices and gathers — the replacement for
the GPU's fixed-function sampler with the reference's sampler state:
repeat addressing, trilinear min/mag/mip filtering (src/Renderer.zig:
506-527; anisotropy 16 is requested there but configs only exercise
trilinear — tracked as a config flag).

sRGB handling matches GPU samplers: BC7_SRGB texels are EOTF-decoded to
linear *before* filtering; alpha (the specular mask, SURVEY §2.4.4) is
linear and untouched.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpurast.assets import bcdec, ktx2

MAX_MIPS = 16


ROW_WIDTH = 52  # 2x2 own-mip quad (16) + 3x3 parent-mip window (36)


@dataclasses.dataclass
class TextureAtlas:
    """Host-side staging of the atlas; `.device()` uploads via jnp.

    Texels are stored as "trilerp rows": entry (x, y) of mip l holds the
    whole 2x2 bilinear footprint [(x,y), (x+1,y), (x,y+1), (x+1,y+1)]
    (neighbors wrapped for repeat addressing, 16 floats) PLUS the 3x3
    window of mip l+1 anchored at ((x-1)//2, (y-1)//2) (36 floats) — the
    parent bilinear footprint for ANY sample point that maps to quad
    (x, y) lands inside that window (offset 0 or 1 on each axis, derived
    per pixel in kernels/shade.py). One gather per TRILINEAR sample
    instead of eight point fetches.
    """

    texels: np.ndarray  # (N, 52) f32 linear RGBA trilerp rows
    offsets: np.ndarray  # (T, MAX_MIPS) i32 flat row offset per mip (256-aligned)
    sizes: np.ndarray  # (T, MAX_MIPS, 2) i32 (width, height) per mip
    n_mips: np.ndarray  # (T,) i32

    def max_value(self) -> float:
        return float(self.texels.max()) if self.texels.size else 0.0

    def device(self, dtype: str = "float16"):
        """Upload; dtype="float16" (default) halves the bytes each gathered
        row moves and is exact for BC6H sources (they are half-float) and
        well below 1 u8 LSB for BC7/BC4 sources (2^-11 relative).
        "float32" preserves bit-exactness against the f32 reference path.

        dtype="srgb8" stores rows as sRGB-encoded u8 (alpha linear u8) —
        EXACTLY the precision of the BC7/BC4 source data (which is u8
        sRGB before decode), 4x smaller than f16: the analog of the
        reference keeping BC-compressed textures resident
        (src/wgpu.zig:130-194). The sampler (kernels/shade._trilerp)
        applies the exact sRGB EOTF after the gather, before filtering —
        the same decode-then-filter order as a GPU sampler. Requires LDR
        content (values in [0, 1]; BC6H scenes keep float16).
        """
        import jax.numpy as jnp
        import ml_dtypes

        host = self.texels
        if dtype == "srgb8":
            assert host.size == 0 or host.max() <= 1.0 + 1e-6, (
                "srgb8 atlas requires LDR content"
            )
            # EXACT sRGB u8 encode via decision boundaries: u8 value k is
            # chosen iff x >= EOTF((k - 0.5)/255), so one searchsorted
            # against the 255 precomputed boundaries replaces a
            # billion-element np.power (minutes -> seconds on the
            # porsche-class atlas) with bit-identical results.
            mid = (np.arange(1, 256, dtype=np.float64) - 0.5) / 255.0
            bounds_srgb = np.where(
                mid <= 0.04045, mid / 12.92, ((mid + 0.055) / 1.055) ** 2.4
            ).astype(np.float32)
            bounds_lin = ((np.arange(1, 256) - 0.5) / 255.0).astype(np.float32)
            # Contiguous (N, 13, 4) views keep the per-lane split cheap
            # (boolean-mask indexing copies the whole table twice).
            texels4 = host.reshape(host.shape[0], -1, 4)
            enc = np.empty(texels4.shape, dtype=np.uint8)
            enc[..., :3] = np.searchsorted(
                bounds_srgb, np.clip(texels4[..., :3], 0.0, 1.0)
            )
            enc[..., 3] = np.searchsorted(
                bounds_lin, np.clip(texels4[..., 3], 0.0, 1.0)
            )
            host = enc.reshape(host.shape)
        elif dtype != "float32":
            np_dtype = {"bfloat16": ml_dtypes.bfloat16, "float16": np.float16}.get(
                dtype, dtype
            )
            host = host.astype(np_dtype)
        texels = jnp.asarray(host)
        return {
            "texels": texels,
            "offsets": jnp.asarray(self.offsets),
            "sizes": jnp.asarray(self.sizes),
            "n_mips": jnp.asarray(self.n_mips),
        }


def _to_linear_rgba(img: np.ndarray, srgb: bool) -> np.ndarray:
    """uint8/float image (H, W, C in {1,3,4}) -> (H, W, 4) f32 linear."""
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    out = np.empty((h, w, 4), dtype=np.float32)
    if img.dtype == np.uint8:
        if srgb:
            out[..., :3] = bcdec.srgb_to_linear(img[..., : min(c, 3)])
        else:
            out[..., :3] = img[..., : min(c, 3)].astype(np.float32) / 255.0
        if c == 1:
            out[..., 1] = out[..., 2] = out[..., 0]
        out[..., 3] = img[..., 3].astype(np.float32) / 255.0 if c == 4 else 1.0
    else:
        out[..., :3] = img[..., : min(c, 3)].astype(np.float32)
        if c == 1:
            out[..., 1] = out[..., 2] = out[..., 0]
        out[..., 3] = img[..., 3].astype(np.float32) if c == 4 else 1.0
    return out


def mip_chain(base: np.ndarray) -> list[np.ndarray]:
    """Box-filter mip chain for procedurally generated textures.
    (KTX2 assets ship their own mips; this is for fallback/synthetic.)"""
    mips = [base]
    m = base
    while m.shape[0] > 1 or m.shape[1] > 1:
        h = max(1, m.shape[0] // 2)
        w = max(1, m.shape[1] // 2)
        m2 = m[: h * 2, : w * 2].reshape(h, 2, w, 2, -1).mean(axis=(1, 3))
        mips.append(m2.astype(np.float32))
        m = m2
    return mips


def fallback_texture(data_dir=None) -> list[np.ndarray]:
    """The reference's embedded fallback texture: 64x64 BC7-sRGB
    black/magenta checkerboard (2x2-texel cells, BLACK at the origin),
    alpha 128 (half-specular mask), 7 shipped mips
    (resources/textures.zig:1, bound at src/Renderer.zig:551-566).

    Decoded from the real resources/textures/missing_diffuse_specular_
    bc7.ktx2 next to the data dir (the analog of the reference's
    @embedFile); falls back to an equivalent procedural pattern when the
    resources tree isn't mounted. tests/test_assets.py pins the decode
    against the procedural reconstruction."""
    if data_dir is not None:
        import os

        path = os.path.join(
            os.path.dirname(os.path.abspath(os.fspath(data_dir))),
            "resources",
            "textures",
            "missing_diffuse_specular_bc7.ktx2",
        )
        if os.path.exists(path):
            return decode_ktx2_texture(ktx2.load_ktx2(path))
    y, x = np.mgrid[0:64, 0:64]
    checker = ((x // 2 + y // 2) % 2 == 1).astype(np.float32)  # black at (0,0)
    base = np.zeros((64, 64, 4), dtype=np.float32)
    base[..., 0] = checker  # magenta squares (sRGB 255 -> linear 1.0)
    base[..., 2] = checker
    base[..., 3] = 128.0 / 255.0  # uniform half-specular mask
    return mip_chain(base)


def decode_ktx2_texture(tex: ktx2.Ktx2Texture) -> list[np.ndarray]:
    """Decode every mip level of a KTX2 texture to linear f32 RGBA."""
    mips = []
    for lvl in tex.levels:
        img = bcdec.decode_level(lvl.data, tex.format_name, lvl.width, lvl.height)
        mips.append(_to_linear_rgba(img, tex.is_srgb))
    return mips


def _trilerp_rows(m: np.ndarray, parent: np.ndarray | None) -> np.ndarray:
    """(H, W, 4) + parent mip -> (H*W, 52) trilerp rows.

    Columns 0:16 are the own-mip quad (2x2 wrapped bilinear footprint);
    16:52 the parent 3x3 window (row-major texel order, 4 channels each)
    anchored at ((x-1)//2 mod w1, (y-1)//2 mod h1). For the last mip
    (parent None) the window is zero — the sampler's mip fraction is
    exactly 0 there. Writes straight into one preallocated row buffer
    (the concat-of-concats formulation re-copied every chunk and
    dominated multi-GB atlas builds).
    """
    h, w = m.shape[:2]
    m = np.ascontiguousarray(m, dtype=np.float32)
    out = np.empty((h * w, ROW_WIDTH), dtype=np.float32)
    own = out[:, :16].reshape(h, w, 4, 4)
    own[..., 0, :] = m
    right = np.roll(m, -1, axis=1)
    own[..., 1, :] = right
    own[..., 2, :] = np.roll(m, -1, axis=0)
    own[..., 3, :] = np.roll(right, -1, axis=0)
    if parent is None:
        out[:, 16:] = 0.0
        return out
    h1, w1 = parent.shape[:2]
    parent = np.ascontiguousarray(parent, dtype=np.float32)
    bx = (np.arange(w) - 1) // 2 % w1  # (W,)
    by = (np.arange(h) - 1) // 2 % h1  # (H,)
    win = out[:, 16:].reshape(h, w, 9, 4)
    for dy in range(3):
        py = (by + dy) % h1
        for dx in range(3):
            px = (bx + dx) % w1
            win[:, :, dy * 3 + dx, :] = parent[py[:, None], px[None, :]]
    return out


def build_atlas(textures: list[list[np.ndarray]]) -> TextureAtlas:
    """Pack per-texture mip pyramids ((H, W, 4) f32 linear each) into the
    flat quad-row atlas. Texture order defines texture ids.

    HOT/COLD packing: mips >= 2 of every texture are allocated FIRST,
    mip 0/1 after. The two largest mips are ~94% of the bytes but a
    minority of samples at screen resolutions (minified content samples
    mid mips), so the frequently-sampled mips share a compact prefix of
    the table. Offsets are absolute, so the sampler is unaffected.
    """
    n_tex = len(textures)
    offsets = np.zeros((n_tex, MAX_MIPS), dtype=np.int32)
    sizes = np.ones((n_tex, MAX_MIPS, 2), dtype=np.int32)
    n_mips = np.zeros(n_tex, dtype=np.int32)
    chunks = []
    cursor = 0

    def alloc(ti, mi, mips):
        nonlocal cursor
        m = mips[mi]
        h, w = m.shape[:2]
        # 256-row alignment: the resolve kernel carries offsets through
        # f32 as offset/256, which is exact only when aligned (raw
        # offsets exceed f32's 2^24 integer range on multi-GB atlases).
        pad = (-cursor) % 256
        if pad:
            chunks.append(np.zeros((pad, ROW_WIDTH), dtype=np.float32))
            cursor += pad
        offsets[ti, mi] = cursor
        sizes[ti, mi] = (w, h)
        parent = mips[mi + 1] if mi + 1 < len(mips) else None
        chunks.append(_trilerp_rows(m, parent))
        cursor += h * w

    for ti, mips in enumerate(textures):
        assert len(mips) <= MAX_MIPS
        # The packed parent-mip 3x3 window and the kernel-side dx/dy in
        # {0,1} anchor derivation (kernels/shade._trilerp) are only
        # wrap-invariant when every mip is exactly half the previous —
        # i.e. power-of-two base dimensions. Enforce instead of sampling
        # wrong parent texels silently (BC textures are always pow2).
        h0, w0 = mips[0].shape[:2]
        if (h0 & (h0 - 1)) or (w0 & (w0 - 1)):
            raise ValueError(
                f"texture {ti}: non-power-of-two base {w0}x{h0} breaks the "
                "single-gather trilinear atlas (parent-window anchors)"
            )
        n_mips[ti] = len(mips)
        for mi in range(2, len(mips)):  # hot zone: mips >= 2
            alloc(ti, mi, mips)
    for ti, mips in enumerate(textures):
        for mi in range(min(2, len(mips))):  # cold zone: mips 0, 1
            alloc(ti, mi, mips)
        # Clamp lod beyond the chain to the last mip.
        for mi in range(len(mips), MAX_MIPS):
            offsets[ti, mi] = offsets[ti, len(mips) - 1]
            sizes[ti, mi] = sizes[ti, len(mips) - 1]
    texels = (
        np.concatenate(chunks, axis=0)
        if chunks
        else np.zeros((1, ROW_WIDTH), dtype=np.float32)
    )
    return TextureAtlas(texels=texels, offsets=offsets, sizes=sizes, n_mips=n_mips)
