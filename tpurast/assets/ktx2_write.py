"""Minimal KTX2 writer + BC4, BC6H and BC7 encoders (asset generation).

The reference ships no BC4u asset despite having the code path
(src/wgpu.zig:137, BASELINE config #3 requires "BC4u monochrome maps"),
and the seeded scenes (device/seeded.py) generate their BC7-sRGB
and HDR textures, so we encode our own: a max/min-endpoint BC4 encoder,
a BC7 mode-6 and a BC6H mode-0x03 encoder, and a KTX2 container writer (optionally Zstandard
supercompressed) — the mirror image of tpurast/assets/ktx2.py. The DFD
block is written as a stub (size-only); tpurast's own parser skips it,
which is all these generated assets need.
"""

from __future__ import annotations

import struct

import numpy as np

_IDENTIFIER = bytes([0xAB, 0x4B, 0x54, 0x58, 0x20, 0x32, 0x30, 0xBB, 0x0D, 0x0A, 0x1A, 0x0A])


def encode_bc4(image: np.ndarray) -> bytes:
    """Encode a (H, W) uint8 image to BC4-unorm blocks (8 bytes/block).

    Per block: endpoints = (max, min) (8-step interpolated mode when they
    differ), indices = nearest palette entry. Not rate-optimal, exact for
    2-level content.
    """
    img = np.asarray(image, dtype=np.uint8)
    h, w = img.shape
    bh, bw = -(-h // 4), -(-w // 4)
    padded = np.zeros((bh * 4, bw * 4), dtype=np.uint8)
    padded[:h, :w] = img
    # Replicate edges into padding so endpoints aren't polluted.
    padded[h:, :w] = img[h - 1 : h, :]
    padded[:, w:] = padded[:, w - 1 : w]

    blocks = padded.reshape(bh, 4, bw, 4).transpose(0, 2, 1, 3).reshape(-1, 16)
    r0 = blocks.max(axis=1).astype(np.int64)  # r0 > r1 -> 8-step mode
    r1 = blocks.min(axis=1).astype(np.int64)
    same = r0 == r1
    r1 = np.where(same, np.maximum(r1 - 1, 0), r1)
    r0 = np.where(same & (r0 == 0), 1, r0)

    k = np.arange(1, 7, dtype=np.int64)
    pal = np.concatenate(
        [r0[:, None], r1[:, None], ((7 - k) * r0[:, None] + k * r1[:, None]) // 7],
        axis=1,
    )  # (N, 8)
    dist = np.abs(blocks[:, :, None].astype(np.int64) - pal[:, None, :])
    idx = np.argmin(dist, axis=2).astype(np.uint64)  # (N, 16)

    out = np.zeros((len(blocks), 8), dtype=np.uint8)
    out[:, 0] = r0.astype(np.uint8)
    out[:, 1] = r1.astype(np.uint8)
    bits = np.zeros(len(blocks), dtype=np.uint64)
    for i in range(16):
        bits |= idx[:, i] << np.uint64(3 * i)
    for b in range(6):
        out[:, 2 + b] = ((bits >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint8)
    return out.tobytes()


# BC7 4-bit index interpolation weights (the format's fixed table).
_BC7_WEIGHTS4 = np.array(
    [0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64], dtype=np.int32
)


def _quantize_mode6_endpoint(v: np.ndarray):
    """(N, 4) 8-bit endpoints -> (7-bit values (N, 4), shared p-bit (N,)).

    Mode 6 stores each endpoint as 7 bits per channel plus one p-bit
    shared by its four channels: value = 2q + p. Picks the p-bit with the
    smaller squared error."""
    best_q = best_p = best_err = None
    for p in (0, 1):
        q = np.clip((v - p + 1) // 2, 0, 127)
        err = (((2 * q + p) - v) ** 2).sum(axis=1)
        if best_err is None:
            best_q, best_p, best_err = q, np.zeros(len(v), np.int32), err
        else:
            take = err < best_err
            best_q = np.where(take[:, None], q, best_q)
            best_p = np.where(take, 1, best_p)
            best_err = np.minimum(err, best_err)
    return best_q, best_p


def encode_bc7_mode6(image: np.ndarray, chunk: int = 16384) -> bytes:
    """Encode a (H, W, 4) uint8 RGBA image to BC7 mode-6 blocks.

    Per block: endpoints are the per-channel min and max (quantized to
    7 bits + p-bit), indices the nearest of the 16 interpolated palette
    entries; the anchor index's high bit is cleared by swapping the
    endpoints. Not rate-optimal. Edge blocks replicate the border.
    """
    img = np.asarray(image, dtype=np.uint8)
    h, w = img.shape[:2]
    bh, bw = -(-h // 4), -(-w // 4)
    padded = np.pad(img, ((0, bh * 4 - h), (0, bw * 4 - w), (0, 0)), mode="edge")
    blocks = (
        padded.reshape(bh, 4, bw, 4, 4).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 4)
    )
    out = np.empty((len(blocks), 16), dtype=np.uint8)
    wts = _BC7_WEIGHTS4[None, :, None]
    for c0 in range(0, len(blocks), chunk):
        px = blocks[c0 : c0 + chunk].astype(np.int32)  # (n, 16, 4)
        n = len(px)
        q0, p0 = _quantize_mode6_endpoint(px.min(axis=1))
        q1, p1 = _quantize_mode6_endpoint(px.max(axis=1))
        e0 = (2 * q0 + p0[:, None])[:, None, :]
        e1 = (2 * q1 + p1[:, None])[:, None, :]
        pal = (e0 * (64 - wts) + e1 * wts + 32) >> 6  # (n, 16 entries, 4)
        dist = np.zeros((n, 16, 16), dtype=np.int32)
        for c in range(4):
            d = px[:, :, None, c] - pal[:, None, :, c]
            dist += d * d
        idx = np.argmin(dist, axis=2).astype(np.int32)  # (n, 16 pixels)
        # Anchor pixel 0 stores 3 bits: its index must be < 8. Swapping
        # the endpoints mirrors the (symmetric) weight table: i -> 15-i.
        swap = idx[:, 0] >= 8
        q0, q1 = np.where(swap[:, None], q1, q0), np.where(swap[:, None], q0, q1)
        p0, p1 = np.where(swap, p1, p0), np.where(swap, p0, p1)
        idx = np.where(swap[:, None], 15 - idx, idx)

        bits = np.zeros((n, 128), dtype=np.uint8)
        off = 0

        def put(v, nbits):
            nonlocal off
            for k in range(nbits):
                bits[:, off + k] = (v >> k) & 1
            off += nbits

        put(np.full(n, 1 << 6, np.int32), 7)  # mode 6
        for c in range(4):  # R0 R1 G0 G1 B0 B1 A0 A1
            put(q0[:, c], 7)
            put(q1[:, c], 7)
        put(p0, 1)
        put(p1, 1)
        put(idx[:, 0], 3)
        for i in range(1, 16):
            put(idx[:, i], 4)
        out[c0 : c0 + n] = np.packbits(bits, axis=1, bitorder="little")
    return out.tobytes()


def encode_bc6h_mode3(image: np.ndarray, chunk: int = 16384) -> bytes:
    """Encode a (H, W, 3) float image (values in [0, 65504]) to BC6H-UF16
    blocks in mode 0x03: one region, 10-bit endpoints stored directly,
    4-bit indices.

    Works in the decoder's 16-bit unquantized domain u (half bits =
    (u * 31) >> 6; a 10-bit endpoint q unquantizes to 64 q + 32): the
    endpoints are the per-channel min and max of u, indices the nearest
    palette entry. Not rate-optimal. Edge blocks replicate the border.
    """
    img = np.clip(np.asarray(image, np.float32), 0.0, 65504.0)
    h, w = img.shape[:2]
    bh, bw = -(-h // 4), -(-w // 4)
    padded = np.pad(img, ((0, bh * 4 - h), (0, bw * 4 - w), (0, 0)), mode="edge")
    half = padded.astype(np.float16).view(np.uint16).astype(np.int64)
    u_all = (half * 64 + 30) // 31  # smallest u with (u * 31) >> 6 == half
    blocks = u_all.reshape(bh, 4, bw, 4, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 3)
    out = np.empty((len(blocks), 16), dtype=np.uint8)
    wts = _BC7_WEIGHTS4[None, :, None].astype(np.int64)
    for c0 in range(0, len(blocks), chunk):
        u = blocks[c0 : c0 + chunk]
        n = len(u)
        q0 = np.clip((u.min(axis=1) - 32 + 32) // 64, 0, 1023)
        q1 = np.clip((u.max(axis=1) - 32 + 32) // 64, 0, 1023)

        def unq(q):
            return np.where(q == 0, 0, np.where(q == 1023, 0xFFFF, q * 64 + 32))

        pal = (unq(q0)[:, None, :] * (64 - wts) + unq(q1)[:, None, :] * wts + 32) >> 6
        dist = ((u[:, :, None, :] - pal[:, None, :, :]) ** 2).sum(-1)  # (n, 16, 16)
        idx = np.argmin(dist, axis=2)
        swap = idx[:, 0] >= 8
        q0, q1 = np.where(swap[:, None], q1, q0), np.where(swap[:, None], q0, q1)
        idx = np.where(swap[:, None], 15 - idx, idx)

        bits = np.zeros((n, 128), dtype=np.uint8)
        off = 0

        def put(v, nbits):
            nonlocal off
            for k in range(nbits):
                bits[:, off + k] = (v >> k) & 1
            off += nbits

        put(np.full(n, 0x03), 5)
        for q in (q0, q1):  # rw gw bw, then rx gx bx
            for c in range(3):
                put(q[:, c], 10)
        put(idx[:, 0], 3)
        for i in range(1, 16):
            put(idx[:, i], 4)
        out[c0 : c0 + n] = np.packbits(bits, axis=1, bitorder="little")
    return out.tobytes()


def make_bc6h_ktx2(image: np.ndarray, full_chain: bool = True) -> bytes:
    """float (H, W, 3) HDR image -> BC6H-UF16 KTX2 blob (mode 0x03 blocks,
    box-filtered mip chain or the base level only, no supercompression)."""
    from tpurast.assets.ktx2 import VK_FORMAT_BC6H_UFLOAT_BLOCK

    mips = [np.asarray(image, np.float32)]
    while full_chain and (mips[-1].shape[0] > 1 or mips[-1].shape[1] > 1):
        m = mips[-1]
        h, w = max(1, m.shape[0] // 2), max(1, m.shape[1] // 2)
        mips.append(m[: h * 2, : w * 2].reshape(h, 2, w, 2, 3).mean(axis=(1, 3)))
    payloads = [encode_bc6h_mode3(m) for m in mips]
    return write_ktx2(
        payloads, VK_FORMAT_BC6H_UFLOAT_BLOCK, image.shape[1], image.shape[0],
        supercompress=False,
    )


def mip_chain_u8(img: np.ndarray) -> list[np.ndarray]:
    """Box-filtered full mip chain for a (H, W) or (H, W, C) uint8 image."""
    mips = [img]
    m = img.astype(np.float32)
    while m.shape[0] > 1 or m.shape[1] > 1:
        h = max(1, m.shape[0] // 2)
        w = max(1, m.shape[1] // 2)
        m = m[: h * 2, : w * 2].reshape(h, 2, w, 2, *m.shape[2:]).mean(axis=(1, 3))
        mips.append(np.round(m).astype(np.uint8))
    return mips


def write_ktx2(
    level_payloads: list[bytes],
    vk_format: int,
    width: int,
    height: int,
    supercompress: bool = True,
) -> bytes:
    """Assemble a KTX2 blob (2D, single layer/face); supercompress=True
    stores each level Zstandard-compressed, False stores it raw."""
    n = len(level_payloads)
    scheme = 2 if supercompress else 0
    if supercompress:
        import zstandard

        cctx = zstandard.ZstdCompressor(level=9)
        stored = [cctx.compress(p) for p in level_payloads]
    else:
        stored = list(level_payloads)

    header = _IDENTIFIER + struct.pack(
        "<9I", vk_format, 1, width, height, 0, 0, 1, n, scheme
    )
    # dfd/kvd/sgd index + level index sizing.
    index_off = len(header)
    level_index_off = index_off + 32
    dfd_off = level_index_off + 24 * n
    dfd = struct.pack("<I", 4)  # stub DFD: totalSize only
    data_off = dfd_off + len(dfd)
    # Levels are stored last-to-first per convention; offsets ascending.
    offsets = []
    cursor = data_off
    for s in reversed(stored):
        offsets.append(cursor)
        cursor += len(s)
    offsets = offsets[::-1]

    index = struct.pack("<2I2I2Q", dfd_off, len(dfd), 0, 0, 0, 0)
    level_index = b"".join(
        struct.pack("<3Q", offsets[i], len(stored[i]), len(level_payloads[i]))
        for i in range(n)
    )
    body = b"".join(s for s in reversed(stored))
    return header + index + level_index + dfd + body


def make_bc4_ktx2(image: np.ndarray, supercompress: bool = True) -> bytes:
    """uint8 (H, W) image -> BC4u KTX2 blob with a full mip chain."""
    from tpurast.assets.ktx2 import VK_FORMAT_BC4_UNORM_BLOCK

    mips = mip_chain_u8(np.asarray(image, dtype=np.uint8))
    payloads = [encode_bc4(m) for m in mips]
    return write_ktx2(
        payloads, VK_FORMAT_BC4_UNORM_BLOCK, image.shape[1], image.shape[0],
        supercompress=supercompress,
    )


def make_bc7_ktx2(image: np.ndarray, srgb: bool = True) -> bytes:
    """uint8 (H, W, 4) RGBA image -> BC7 KTX2 blob (mode-6 blocks, full
    box-filtered mip chain, no supercompression)."""
    from tpurast.assets.ktx2 import VK_FORMAT_BC7_SRGB_BLOCK, VK_FORMAT_BC7_UNORM_BLOCK

    mips = mip_chain_u8(np.asarray(image, dtype=np.uint8))
    payloads = [encode_bc7_mode6(m) for m in mips]
    fmt = VK_FORMAT_BC7_SRGB_BLOCK if srgb else VK_FORMAT_BC7_UNORM_BLOCK
    return write_ktx2(payloads, fmt, image.shape[1], image.shape[0], supercompress=False)
