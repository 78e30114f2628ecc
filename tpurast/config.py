"""Renderer configuration.

The reference hardcodes every tunable (SURVEY.md §5 "Config / flag system"):
window 1280x720 (src/Engine.zig:56), vfov 80 deg / znear 0.01
(src/Renderer.zig:468-474), move speed 2.0 (src/Camera.zig:73), mouse
sensitivity 0.002 (src/Camera.zig:103), light constants
(shaders/src/basic.frag:15-17), clear color magenta (src/Renderer.zig:1008).
We expose them as a dataclass whose defaults reproduce the reference values.
"""

from __future__ import annotations

import dataclasses
import math


def _normalize3(v: tuple[float, float, float]) -> tuple[float, float, float]:
    n = math.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    return (v[0] / n, v[1] / n, v[2] / n)


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    # Render target (reference: 1280x720 window, src/Engine.zig:56).
    width: int = 1280
    height: int = 720

    # Projection (src/Renderer.zig:468-475): vfov 80 deg, znear 0.01,
    # infinite far plane with reversed-Z.
    vfov_deg: float = 80.0
    znear: float = 0.01

    # Clear values (src/Renderer.zig:1008, :1014): magenta color, depth 0.0
    # (reversed-Z "far").
    clear_color: tuple[float, float, float, float] = (1.0, 0.0, 1.0, 1.0)
    clear_depth: float = 0.0

    # Directional light (shaders/src/basic.frag:15-17).
    light_color: tuple[float, float, float] = (0.86, 0.65, 0.35)
    light_direction: tuple[float, float, float] = _normalize3((1.0, -1.0, 1.0))
    ambient_amount: float = 0.1
    specular_power: float = 32.0

    # Camera (src/Camera.zig:73, :103-105).
    move_speed: float = 2.0
    mouse_sensitivity: float = 0.002
    pitch_limit: float = 0.5 * math.pi - 0.01

    # --- Pipeline tunables (no reference analog; the GPU rasterizer's
    # fixed-function tiling made these implicit). ---
    # Framebuffer tile size: one raster program owns one tile and keeps
    # its depth/face-id block in registers, so both sides are powers of
    # two (Triton block shapes). 32x32 gives 2040 tiles at 1080p — about
    # 15 per SM of a 132-SM card — while keeping the dense per-tile work
    # of large triangles small.
    tile_h: int = 32
    tile_w: int = 32
    # Binned-pair buffer capacity (static shape): total (tile, face)
    # pairs per frame for the scan binning path. None = auto (4x the
    # padded face count — generous; typical scenes emit < 2 pairs/face).
    # Truncation is counted in the frame's bin_overflow.
    bin_capacity: int | None = None
    # Extra raster work segments beyond one-per-tile (covers tiles whose
    # bins exceed 128 triangles). Each segment is a (tile, 128-triangle
    # chunk) run of setup rows; see kernels/raster.py.
    segment_headroom: int = 8192

    # Binning algorithm: "pairs" emits (tile, face) pairs and 2-key-sorts
    # them (O(pairs log pairs)); "scan" is the chunked rank-by-cumsum
    # scan, O(tiles x faces) but sort-free. "auto" picks pairs. See
    # kernels/geometry.py.
    binning: str = "auto"

    # Atlas texel dtype. "auto" (default): float16 normally — exact for
    # BC6H sources, <1 u8 LSB for BC7 — switching to "srgb8" (u8 rows,
    # sRGB-encoded RGB + linear alpha: EXACTLY the BC source precision,
    # 4x smaller) when the f16 atlas would exceed ~2 GB and content is
    # LDR. "float32" is bit-exact to the f32 sampling reference;
    # "float16"/"bfloat16"/"srgb8" select explicitly.
    texture_dtype: str = "auto"

    # Texture sampling anisotropy: ratio-clamped probes along the
    # major-axis gradient, implemented in both shading paths
    # (kernels/shade.aniso_footprint). Default 16 matches the reference
    # sampler, which always requests maxAnisotropy 16
    # (src/Renderer.zig:515).
    max_anisotropy: int = 16
    # Framebuffer blend state (src/Renderer.zig:447-458): "alpha" is the
    # reference's srcAlpha/oneMinusSrcAlpha+add color blend with zero/one
    # alpha blend; "opaque" bypasses the blend equation.
    blend: str = "alpha"

    # Shading path: "forward" gathers per-pixel attributes into a
    # G-buffer (kernels/resolve.py) before texturing; "deferred" is the
    # per-pixel fat-gather path (same output, kept for verification).
    shading: str = "forward"

    @property
    def vfov(self) -> float:
        return math.radians(self.vfov_deg)

    @property
    def aspect(self) -> float:
        return self.width / self.height


DEFAULT_CONFIG = RendererConfig()
