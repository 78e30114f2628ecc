"""Frame-stats overlay — the Dear ImGui replacement.

The reference draws a semi-transparent "Frametime: X ms" box pinned
top-left plus a settings window with a VSync checkbox
(src/Renderer.zig:965-976, :1182-1207). Headless equivalent: the overlay
is composited onto the presented host image in numpy (a 3x5 bitmap font
scaled 2x), and the "settings" surface is the RendererConfig/engine API.
"""

from __future__ import annotations

import numpy as np

# 3x5 glyphs, one string of 15 bits (rows top to bottom) per character.
_GLYPHS = {
    "0": "111101101101111",
    "1": "010110010010111",
    "2": "111001111100111",
    "3": "111001111001111",
    "4": "101101111001001",
    "5": "111100111001111",
    "6": "111100111101111",
    "7": "111001001001001",
    "8": "111101111101111",
    "9": "111101111001111",
    ".": "000000000000010",
    "m": "000000111111101",
    "s": "000011100001110",
    " ": "000000000000000",
}
_SCALE = 2
_BOX_RGB = np.array([20, 20, 30], np.float32)
_BOX_ALPHA = 90.0 / 255.0  # ImGui overlay bg alpha 0.35 (src/Renderer.zig:1196)
_TEXT_RGB = np.array([230, 230, 235], np.uint8)


def _text_mask(text: str) -> np.ndarray:
    """(5*S, 4*S*len) bool mask of `text` in the bitmap font."""
    cols = []
    for ch in text:
        g = np.array([c == "1" for c in _GLYPHS.get(ch, _GLYPHS[" "])]).reshape(5, 3)
        cols.append(np.pad(g, ((0, 0), (0, 1))))  # one column of spacing
    mask = np.concatenate(cols, axis=1)
    return np.kron(mask, np.ones((_SCALE, _SCALE), bool)).astype(bool)


def draw_frametime_overlay(frame: np.ndarray, frametime_ms: float) -> np.ndarray:
    """Composite the stats box onto an (H, W, 3|4) u8 frame (copy)."""
    img = np.array(frame, dtype=np.uint8, copy=True)
    mask = _text_mask(f"{frametime_ms:8.5f} ms")
    x, y, pad = 8, 8, 4
    y0, x0 = max(y - pad, 0), max(x - pad, 0)
    y1 = min(y + mask.shape[0] + pad, img.shape[0])
    x1 = min(x + mask.shape[1] + pad, img.shape[1])
    box = img[y0:y1, x0:x1, :3].astype(np.float32)
    img[y0:y1, x0:x1, :3] = np.round(
        box * (1.0 - _BOX_ALPHA) + _BOX_RGB * _BOX_ALPHA
    ).astype(np.uint8)
    m = mask[: max(img.shape[0] - y, 0), : max(img.shape[1] - x, 0)]
    img[y : y + m.shape[0], x : x + m.shape[1], :3][m] = _TEXT_RGB
    return img


class FrameStats:
    """Rolling frame-time statistics (reference: per-frame wall-clock
    delta, src/Engine.zig:190-195; we add percentiles for the bench)."""

    def __init__(self, window: int = 240) -> None:
        self.window = window
        self.samples_ms: list[float] = []

    def record(self, seconds: float) -> None:
        self.samples_ms.append(seconds * 1e3)
        if len(self.samples_ms) > self.window:
            self.samples_ms.pop(0)

    @property
    def last_ms(self) -> float:
        return self.samples_ms[-1] if self.samples_ms else 0.0

    def percentile(self, p: float) -> float:
        if not self.samples_ms:
            return 0.0
        return float(np.percentile(np.asarray(self.samples_ms), p))

    @property
    def p50_ms(self) -> float:
        return self.percentile(50)

    @property
    def fps(self) -> float:
        p50 = self.p50_ms
        return 1000.0 / p50 if p50 > 0 else 0.0
