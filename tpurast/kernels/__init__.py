"""The wgpu-native replacement: GPU compute stages (XLA + one Pallas kernel).

Pipeline stages (one jit-compiled frame function, see tpurast.renderer):

  geometry.py — vertex transform, clipless 2D-homogeneous triangle
                setup, back-face cull, tiled binning
  raster.py   — visibility raster: per-tile edge tests + reversed-Z
                GreaterEqual depth (Pallas kernel through Triton, plus
                the plain jax.numpy formulation it is checked against)
  resolve.py  — per-pixel G-buffer: gather of the winning face's
                attributes, perspective-correct interpolation, mip select
  shade.py    — texture gather + textured Lambert/Phong (basic.frag port
                at the semantic level)
  present.py  — linear -> sRGB encode, host readback helpers

Design notes: rasterization uses homogeneous edge functions (adjugate of
the clip-space vertex matrix), so no polygon clipping is ever needed —
triangles crossing w=0 are handled by sign-region tests. This replaces the
wgpu fixed-function rasterizer state at src/Renderer.zig:396-462 (CCW
front, back cull, Depth32Float GreaterEqual, no MSAA).
"""

import jax


def interpret_mode() -> bool:
    """Whether Pallas kernels run in the interpreter (read at trace time).

    The CPU backend (the test suite) interprets; the GPU backend compiles
    through Triton. Any other backend has no compiled route and raises
    rather than silently interpreting on an accelerator.
    """
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(
        f"no Pallas route for backend {backend!r}: kernels compile for 'gpu' "
        "and are interpreted only on 'cpu'"
    )
