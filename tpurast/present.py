"""Double-buffered device->host framebuffer readback.

The swapchain/present replacement (BASELINE north star): while the GPU
computes frame N, frame N-1's color buffer transfers to host. JAX arrays
are async by construction — `copy_to_host_async()` starts the DMA and
`np.asarray` on the *previous* frame overlaps that transfer with the
current frame's compute, exactly the compute/transfer overlap the
reference gets from wgpuSurfacePresent + non-blocking wgpuDevicePoll
(src/Renderer.zig:1076-1081).
"""

from __future__ import annotations

import numpy as np


def interleave(img: np.ndarray) -> np.ndarray:
    """(4, H, W) channel-planar (the device framebuffer layout) ->
    (H, W, 4) interleaved host image. The host-side half of the swapchain's
    surface-format conversion."""
    if img.ndim == 3 and img.shape[0] == 4:
        return np.ascontiguousarray(np.moveaxis(img, 0, -1))
    return img


class Presenter:
    """present(frame_n) -> host image of frame_{n-1} (None on first call)."""

    def __init__(self) -> None:
        self._in_flight = None

    def present(self, device_frame) -> np.ndarray | None:
        try:
            device_frame.copy_to_host_async()
        except AttributeError:
            pass  # non-jax arrays (tests) skip the async hint
        previous, self._in_flight = self._in_flight, device_frame
        if previous is None:
            return None
        return interleave(np.asarray(previous))

    def flush(self) -> np.ndarray | None:
        """Drain the last in-flight frame (end of the run loop)."""
        last, self._in_flight = self._in_flight, None
        return None if last is None else interleave(np.asarray(last))
