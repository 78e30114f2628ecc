"""Engine: the app framework (src/Engine.zig equivalent, headless).

Owns the renderer, the demo scene, the fly camera, the frame loop, and
frame statistics. Input arrives as per-tick `MoveDirection` + mouse deltas
(the GLFW callback layer of the reference maps keys/mouse to exactly these,
src/Engine.zig:205-225); a scripted `controller` drives flythroughs.

Startup mirrors Engine.init: load the 4-model demo scene with its
placements (:110-141), camera at -2.5*forward looking at +forward
(:157-160), 1280x720 default target (:56).
"""

from __future__ import annotations

import logging
import time
from typing import Callable

import numpy as np

from tpurast import compile_cache, math3d
from tpurast.camera import Camera, MoveDirection
from tpurast.config import RendererConfig
from tpurast.device.scene import DeviceScene, load_demo_scene
from tpurast.overlay import FrameStats, draw_frametime_overlay
from tpurast.present import Presenter
from tpurast.renderer import Renderer

log = logging.getLogger("tpurast.engine")

#: controller(frame_index, engine) -> (MoveDirection, (mouse_dx, mouse_dy))
Controller = Callable[[int, "Engine"], tuple[MoveDirection, tuple[float, float]]]


class Engine:
    MAX_TIMESTEP = 0.25  # seconds; see tick()

    def __init__(
        self,
        data_dir: str | None = None,
        scene: DeviceScene | None = None,
        config: RendererConfig | None = None,
        overlay: bool = True,
    ):
        compile_cache.enable()
        self.config = config or RendererConfig()
        if scene is None:
            if data_dir is None:
                raise ValueError("need data_dir or a prebuilt scene")
            scene = load_demo_scene(data_dir)
        self.renderer = Renderer(scene, self.config)
        fwd = math3d.WORLD_SPACE.forward.vector()
        self.camera = Camera.from_target(fwd * -2.5, fwd)
        self.presenter = Presenter()
        self.stats = FrameStats()
        self.overlay_enabled = overlay
        # The reference's single runtime toggle: the ImGui VSync checkbox
        # flips present mode Fifo/Immediate (src/Renderer.zig:970-973).
        # Headless analog: cap the loop at 60 Hz when enabled.
        self.vsync = False
        self._last_instant: float | None = None
        # Overflow surfacing (device-lost analog, src/Renderer.zig:1209):
        # the previous frame's bin_overflow scalar is fetched one frame
        # late so the read never stalls the async pipeline. Counts
        # dropped (tile, face) pairs + dropped raster segments.
        self._pending_overflow = None
        self.overflow_frames = 0
        self.dropped_total = 0
        self.frame_index = 0

    # -- one tick: update + render + present ------------------------------
    def tick(
        self,
        move: MoveDirection = MoveDirection(),
        mouse_delta: tuple[float, float] = (0.0, 0.0),
    ) -> np.ndarray | None:
        """Advance one frame. Returns the *previous* frame's host image
        (double-buffered present), None on the first tick."""
        now = time.perf_counter()
        dt = 0.0 if self._last_instant is None else now - self._last_instant
        self._last_instant = now
        # Max-timestep clamp: the first frames pay XLA compilation (tens of
        # seconds); without a clamp a scripted flythrough teleports. The
        # reference needs no clamp (no compile stalls) — this is a
        # compile-stall guard, not a behavior change at 60 Hz.
        dt = min(dt, self.MAX_TIMESTEP)

        # Update (src/Engine.zig:205-225): move then mouse look.
        if dt > 0.0:
            self.camera = self.camera.translate(dt, move)
        if mouse_delta != (0.0, 0.0):
            self.camera = self.camera.update_orientation(*mouse_delta)

        frame = self.renderer.render(self.camera)
        image = self.presenter.present(frame["color"])
        # Check the PREVIOUS frame's overflow counter (completed by now —
        # fetching it does not block this frame's dispatch).
        self._check_overflow()
        self._pending_overflow = frame["bin_overflow"]
        if self.vsync:
            budget = 1.0 / 60.0
            elapsed = time.perf_counter() - now
            if elapsed < budget:
                time.sleep(budget - elapsed)
        after = time.perf_counter()
        self.stats.record(after - now)
        self.frame_index += 1

        if image is not None and self.overlay_enabled:
            image = draw_frametime_overlay(image, self.stats.last_ms)
        return image

    def _check_overflow(self) -> None:
        """Fetch the pending frame's dropped-pair counter and account it."""
        if self._pending_overflow is None:
            return
        dropped = int(np.asarray(self._pending_overflow))
        self._pending_overflow = None
        if dropped:
            self.overflow_frames += 1
            self.dropped_total += dropped
            log.warning(
                "frame %d: %d binned pairs/segments dropped — raise "
                "bin_capacity/segment_headroom (RendererConfig)",
                self.frame_index - 1,
                dropped,
            )

    def run(
        self,
        num_frames: int,
        controller: Controller | None = None,
        on_frame: Callable[[int, np.ndarray], None] | None = None,
    ) -> np.ndarray:
        """Run the frame loop (src/Engine.zig:182-199 without the window).

        Returns the final presented frame.
        """
        last = None
        for i in range(num_frames):
            move, mouse = (
                controller(i, self) if controller else (MoveDirection(), (0.0, 0.0))
            )
            image = self.tick(move, mouse)
            if image is not None:
                last = image
                if on_frame:
                    on_frame(i, image)
        tail = self.presenter.flush()
        self._check_overflow()
        if tail is not None:
            tail_img = np.asarray(tail)
            if self.overlay_enabled:
                tail_img = draw_frametime_overlay(tail_img, self.stats.last_ms)
            last = tail_img
            if on_frame:
                on_frame(num_frames, last)
        log.info(
            "ran %d frames: p50 %.3f ms (%.1f FPS)",
            num_frames,
            self.stats.p50_ms,
            self.stats.fps,
        )
        return last

    # -- resize (src/Engine.zig:227-229) ----------------------------------
    def resize(self, width: int, height: int) -> None:
        self.renderer.recreate_swapchain(width, height)
