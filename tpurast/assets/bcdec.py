"""BC block-compression decoders (numpy reference implementation).

Replaces the GPU's fixed-function BC sampling that the reference relies on
(wgpu `TextureCompressionBC` feature, src/Renderer.zig:216-221; format
mapping src/wgpu.zig:136-159): BC7 (8 modes), BC4 unsigned, and BC6H
(half-float HDR) blocks are decoded on host into texel mip pyramids that
live on the device for the texture gathers.

All decoders are vectorized over blocks. A C++ fast path with identical
output lives in native/ (see tpurast.assets.native); tests fuzz both against
Pillow's independent decoder.

Layout reference: Khronos Data Format Specification §BC7/§BC6H/§BC4. The
partition/anchor constant tables are in _bc7_tables.py (empirically
recovered, see tools/derive_bc7_tables.py).
"""

from __future__ import annotations

import functools

import numpy as np

from tpurast.assets._bc7_tables import (
    ANCHOR_SECOND_2,
    ANCHOR_SECOND_3,
    ANCHOR_THIRD_3,
    PARTITIONS_2,
    PARTITIONS_3,
)

WEIGHTS = {
    2: np.array([0, 21, 43, 64], dtype=np.int64),
    3: np.array([0, 9, 18, 27, 37, 46, 55, 64], dtype=np.int64),
    4: np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64], dtype=np.int64),
}

# Per-mode properties: (num_subsets, partition_bits, rotation_bits,
# index_selection_bits, color_bits, alpha_bits, endpoint_pbits_total,
# shared_pbits_total, index_bits, index2_bits)
_BC7_MODES = {
    0: (3, 4, 0, 0, 4, 0, 6, 0, 3, 0),
    1: (2, 6, 0, 0, 6, 0, 0, 2, 3, 0),
    2: (3, 6, 0, 0, 5, 0, 0, 0, 2, 0),
    3: (2, 6, 0, 0, 7, 0, 4, 0, 2, 0),
    4: (1, 0, 2, 1, 5, 6, 0, 0, 2, 3),
    5: (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
    6: (1, 0, 0, 0, 7, 7, 2, 0, 4, 0),
    7: (2, 6, 0, 0, 5, 5, 4, 0, 2, 0),
}


def _unpack_bits(blocks: np.ndarray) -> np.ndarray:
    """(N, B) uint8 -> (N, 8B) bit array, LSB-first within each byte."""
    return np.unpackbits(blocks, axis=1, bitorder="little")


def _field(bits: np.ndarray, off: int, n: int) -> np.ndarray:
    """Extract an n-bit little-endian field starting at bit `off`."""
    if n == 0:
        return np.zeros(bits.shape[0], dtype=np.int64)
    w = (np.int64(1) << np.arange(n, dtype=np.int64))
    return bits[:, off : off + n].astype(np.int64) @ w


def _expand_to_8(v: np.ndarray, bits: int) -> np.ndarray:
    """Left-align then replicate high bits (color endpoint dequantization)."""
    if bits >= 8:
        return v
    v = v << (8 - bits)
    return v | (v >> bits)


@functools.lru_cache(maxsize=None)
def _index_layout(ns: int, ib: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-partition (offsets, widths) of each pixel's index field.

    Anchor pixels (subset starts) store one less bit — their implicit MSB
    is 0. Returns arrays of shape (64, 16).
    """
    offsets = np.zeros((64, 16), dtype=np.int64)
    widths = np.zeros((64, 16), dtype=np.int64)
    for p in range(64):
        anchors = {0}
        if ns == 2:
            anchors.add(int(ANCHOR_SECOND_2[p]))
        elif ns == 3:
            anchors.add(int(ANCHOR_SECOND_3[p]))
            anchors.add(int(ANCHOR_THIRD_3[p]))
        w = np.array([ib - 1 if i in anchors else ib for i in range(16)], dtype=np.int64)
        widths[p] = w
        offsets[p] = np.concatenate(([0], np.cumsum(w)[:-1]))
    return offsets, widths


def _index_values(
    bits: np.ndarray, base: int, ib: int, ns: int, partition: np.ndarray
) -> np.ndarray:
    """Decode per-pixel indices; (Nm, 16) int64."""
    offs, wids = _index_layout(ns, ib)
    off = offs[partition]  # (Nm, 16)
    wid = wids[partition]
    k = np.arange(ib, dtype=np.int64)
    gather = np.minimum(base + off[:, :, None] + k, bits.shape[1] - 1)
    n = bits.shape[0]
    vals = np.take_along_axis(bits, gather.reshape(n, -1), axis=1).reshape(n, 16, ib)
    mask = k < wid[:, :, None]
    return (vals.astype(np.int64) * mask) @ (np.int64(1) << k)


def _interp(e0: np.ndarray, e1: np.ndarray, weight: np.ndarray) -> np.ndarray:
    """BC7/BC6H palette interpolation: (a*(64-w) + b*w + 32) >> 6."""
    return (e0 * (64 - weight) + e1 * weight + 32) >> 6


def decode_bc7(blocks: np.ndarray) -> np.ndarray:
    """Decode BC7 blocks. (N, 16) uint8 -> (N, 4, 4, 4) uint8 RGBA."""
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8).reshape(-1, 16)
    n = blocks.shape[0]
    bits = _unpack_bits(blocks)
    out = np.zeros((n, 16, 4), dtype=np.uint8)

    # Mode = position of the lowest set bit of the first byte; all-zero low
    # byte is an invalid block and decodes to transparent black.
    first = blocks[:, 0].astype(np.int64)
    mode_of = np.full(n, -1, dtype=np.int64)
    for m in range(7, -1, -1):
        mode_of[(first & ((1 << (m + 1)) - 1)) == (1 << m)] = m

    for m, (ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2) in _BC7_MODES.items():
        sel = np.nonzero(mode_of == m)[0]
        if len(sel) == 0:
            continue
        b = bits[sel]
        off = m + 1
        partition = _field(b, off, pb)
        off += pb
        rotation = _field(b, off, rb)
        off += rb
        index_sel = _field(b, off, isb)
        off += isb

        n_ep = 2 * ns
        # Endpoints: all R fields, then G, then B, then A (LSB-first fields,
        # endpoint order s0e0, s0e1, s1e0, s1e1, ...).
        eps = np.zeros((len(sel), n_ep, 4), dtype=np.int64)
        for c, nbits in ((0, cb), (1, cb), (2, cb), (3, ab)):
            for e in range(n_ep):
                if nbits:
                    eps[:, e, c] = _field(b, off, nbits)
                    off += nbits

        # P-bits: appended as the shared LSB of every channel.
        cbits, abits = cb, ab
        if epb:
            p = np.stack([_field(b, off + e, 1) for e in range(n_ep)], axis=1)
            off += epb
            eps[:, :, :3] = (eps[:, :, :3] << 1) | p[:, :, None]
            cbits += 1
            if ab:
                eps[:, :, 3] = (eps[:, :, 3] << 1) | p
                abits += 1
        elif spb:
            p = np.stack([_field(b, off + s, 1) for s in range(ns)], axis=1)
            off += spb
            p_per_ep = np.repeat(p, 2, axis=1)
            eps[:, :, :3] = (eps[:, :, :3] << 1) | p_per_ep[:, :, None]
            cbits += 1

        rgb = _expand_to_8(eps[:, :, :3], cbits)
        if ab:
            alpha = _expand_to_8(eps[:, :, 3:4], abits)
        else:
            alpha = np.full_like(eps[:, :, 3:4], 255)
        eps8 = np.concatenate([rgb, alpha], axis=2)  # (Nm, n_ep, 4)

        # Indices.
        idx1 = _index_values(b, off, ib, ns, partition)
        off += 16 * ib - ns
        if ib2:
            idx2 = _index_values(b, off, ib2, ns, partition)
        else:
            idx2 = None

        if ns == 1:
            subset = np.zeros((len(sel), 16), dtype=np.int64)
        elif ns == 2:
            subset = PARTITIONS_2[partition].astype(np.int64)
        else:
            subset = PARTITIONS_3[partition].astype(np.int64)

        e0 = np.take_along_axis(eps8, (subset * 2)[:, :, None], axis=1)
        e1 = np.take_along_axis(eps8, (subset * 2 + 1)[:, :, None], axis=1)

        if idx2 is None:
            w = WEIGHTS[ib][idx1][:, :, None]
            px = _interp(e0, e1, w)
        else:
            # Mode 4/5: separate color and alpha indices. Mode 4's index
            # selection bit swaps which set drives color.
            cw_bits, aw_bits = ib, ib2
            cidx, aidx = idx1, idx2
            if isb:
                swap = index_sel.astype(bool)
                cidx = np.where(swap[:, None], idx2, idx1)
                aidx = np.where(swap[:, None], idx1, idx2)
                cw = np.where(swap[:, None], WEIGHTS[ib2][idx2], WEIGHTS[ib][idx1])
                aw = np.where(swap[:, None], WEIGHTS[ib][idx1], WEIGHTS[ib2][idx2])
            else:
                cw = WEIGHTS[cw_bits][cidx]
                aw = WEIGHTS[aw_bits][aidx]
            px = np.empty((len(sel), 16, 4), dtype=np.int64)
            px[:, :, :3] = _interp(e0[:, :, :3], e1[:, :, :3], cw[:, :, None])
            px[:, :, 3] = _interp(e0[:, :, 3], e1[:, :, 3], aw)

        if rb:
            # Rotation: swap alpha with R/G/B post-interpolation.
            perm_table = np.array(
                [[0, 1, 2, 3], [3, 1, 2, 0], [0, 3, 2, 1], [0, 1, 3, 2]], dtype=np.int64
            )
            perm = perm_table[rotation]  # (Nm, 4)
            px = np.take_along_axis(px, perm[:, None, :], axis=2)

        out[sel] = px.astype(np.uint8)

    return out.reshape(n, 4, 4, 4)


def decode_bc4(blocks: np.ndarray, snorm: bool = False) -> np.ndarray:
    """Decode BC4 blocks. (N, 8) uint8 -> (N, 4, 4) uint8 (unorm path).

    Palette: r0 > r1 -> 8-step ramp; else 6-step ramp + 0 + 255
    (Khronos DFS §BC4; reference maps vkFormat 139, src/wgpu.zig:137).
    """
    if snorm:
        raise NotImplementedError("BC4 snorm not used by any reference asset")
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8).reshape(-1, 8)
    n = blocks.shape[0]
    r0 = blocks[:, 0].astype(np.int64)
    r1 = blocks[:, 1].astype(np.int64)

    # Palettes, both variants, selected per block.
    k = np.arange(1, 7, dtype=np.int64)
    pal8 = np.concatenate(
        [r0[:, None], r1[:, None], ((7 - k) * r0[:, None] + k * r1[:, None]) // 7],
        axis=1,
    )
    k5 = np.arange(1, 5, dtype=np.int64)
    pal6 = np.concatenate(
        [
            r0[:, None],
            r1[:, None],
            ((5 - k5) * r0[:, None] + k5 * r1[:, None]) // 5,
            np.zeros((n, 1), dtype=np.int64),
            np.full((n, 1), 255, dtype=np.int64),
        ],
        axis=1,
    )
    pal = np.where((r0 > r1)[:, None], pal8, pal6)

    bits = _unpack_bits(blocks)[:, 16:]  # 48 index bits
    k3 = np.arange(3, dtype=np.int64)
    idx = (
        bits.reshape(n, 16, 3).astype(np.int64) @ (np.int64(1) << k3)
    )  # (N, 16)
    vals = np.take_along_axis(pal, idx, axis=1)
    return vals.astype(np.uint8).reshape(n, 4, 4)


def decode_bc6h(blocks: np.ndarray, signed: bool = False) -> np.ndarray:
    """Decode BC6H blocks. (N, 16) uint8 -> (N, 4, 4, 3) float32 (HDR).

    Implemented in bc6h.py; re-exported here for a single decode surface.
    """
    from tpurast.assets.bc6h import decode_bc6h as _impl

    return _impl(blocks, signed=signed)


def assemble_blocks(decoded: np.ndarray, blocks_x: int, blocks_y: int, width: int, height: int) -> np.ndarray:
    """(N, 4, 4, C) or (N, 4, 4) block texels -> (height, width[, C]) image."""
    if decoded.ndim == 3:
        decoded = decoded[..., None]
    c = decoded.shape[-1]
    img = (
        decoded.reshape(blocks_y, blocks_x, 4, 4, c)
        .transpose(0, 2, 1, 3, 4)
        .reshape(blocks_y * 4, blocks_x * 4, c)
    )
    img = img[:height, :width]
    return img if c > 1 else img[..., 0]


def decode_level(data: bytes, format_name: str, width: int, height: int) -> np.ndarray:
    """Decode one mip level's block payload into an image array.

    BC7/BC4 return uint8, BC6H float32. Rows contain ceil(w/4) blocks of
    8/16 bytes, matching the reference's upload stride computation
    (src/wgpu.zig:367-413: bytesPerRow = ceil(w/4)*blockSize).
    """
    from tpurast.assets import native

    use_native = native.available()
    bx = max(1, (width + 3) // 4)
    by = max(1, (height + 3) // 4)
    raw = np.frombuffer(data, dtype=np.uint8)
    if format_name == "bc7":
        blocks = raw.reshape(by * bx, 16)
        dec = native.decode_bc7 if use_native else decode_bc7
        return assemble_blocks(dec(blocks), bx, by, width, height)
    if format_name == "bc4u":
        blocks = raw.reshape(by * bx, 8)
        dec = native.decode_bc4 if use_native else decode_bc4
        return assemble_blocks(dec(blocks), bx, by, width, height)
    if format_name in ("bc6h_uf", "bc6h_sf"):
        blocks = raw.reshape(by * bx, 16)
        dec = native.decode_bc6h if use_native else decode_bc6h
        return assemble_blocks(
            dec(blocks, signed=format_name == "bc6h_sf"), bx, by, width, height
        )
    raise ValueError(f"unknown block format {format_name}")


def srgb_to_linear(srgb_u8: np.ndarray) -> np.ndarray:
    """sRGB EOTF (the GPU sampler applies this before filtering for
    *_SRGB formats; we do the same before mip filtering)."""
    c = srgb_u8.astype(np.float32) / 255.0
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


def linear_to_srgb(linear: np.ndarray) -> np.ndarray:
    c = np.clip(linear, 0.0, 1.0)
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055).astype(
        np.float32
    )
