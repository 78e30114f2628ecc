"""Present stage: format conversion + device->host readback.

Replaces the swapchain/present path (src/Renderer.zig:1080,
surfaceGetNextTextureView src/wgpu.zig:291-328): the linear-color
framebuffer is encoded to the surface format (sRGB u8, matching the
reference's preferred *Srgb surface formats, src/Renderer.zig:359-370)
on-device, then read back. Double buffering lives in tpurast.present
(host side): frame N computes while frame N-1 transfers.
"""

from __future__ import annotations

import jax.numpy as jnp


def linear_to_srgb(c):
    c = jnp.clip(c, 0.0, 1.0)
    return jnp.where(c <= 0.0031308, c * 12.92, 1.055 * jnp.power(c, 1.0 / 2.4) - 0.055)


def encode_srgb_u8(planes, width: int, height: int):
    """(4, Hp, Wp) linear f32 planes -> (4, height, width) sRGB u8
    planes, cropping tile padding. Alpha is linear (pass-through).

    Channel-PLANAR throughout, like the shading planes; the host-side
    presenter interleaves to (H, W, 4) after readback (tpurast/present.py)
    — the analog of the swapchain's surface-format swizzle."""
    fb = planes[:, :height, :width]
    rgb = linear_to_srgb(fb[:3])
    a = jnp.clip(fb[3:4], 0.0, 1.0)
    out = jnp.concatenate([rgb, a], axis=0)
    return jnp.round(out * 255.0).astype(jnp.uint8)


def crop_linear(framebuffer, width: int, height: int):
    """(..., Hp, Wp) -> (..., height, width) linear f32 (RGBA16Float-
    surface analog: the reference's top surface-format preference is
    RGBA16Float, src/Renderer.zig:359-363)."""
    return framebuffer[..., :height, :width]
