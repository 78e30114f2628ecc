"""tpurast — a rasterization engine in JAX for NVIDIA GPUs.

A 3D forward renderer with the capabilities of
arctic-marmoset/wgpu-renderer (Zig + wgpu): glTF-binary mesh loading, KTX2
block-compressed textures (BC7/BC6H/BC4u, Zstandard supercompressed), a
right-handed +Z-forward world with reversed-Z infinite-far-plane depth,
per-material texture binding, a fly camera, and a frame-stats overlay.

The compute path is JAX/XLA/Pallas: vertex transform, clip/backface cull,
tiled triangle binning, reversed-Z depth test, perspective-correct attribute
interpolation, textured Lambert + Phong shading — fused kernels over
device-resident framebuffer tiles. The GLFW swapchain of the reference is
replaced by double-buffered device→host framebuffer readback.

Layer map (mirrors SURVEY.md §1):
  math3d / camera      — L3/L5 math & camera (host numpy, reference semantics)
  assets/              — glTF-binary + KTX2 + BC block decode (libktx equivalent)
  device/              — scene/texture device residency (wgpu buffer/texture equivalent)
  kernels/             — the wgpu-native replacement (XLA + Pallas)
  engine               — L5/L6 app framework: init, load scene, run loop
  overlay              — frame-stats overlay (ImGui equivalent)
"""

__version__ = "0.1.0"

from tpurast.config import RendererConfig  # noqa: F401
