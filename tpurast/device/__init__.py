"""Device residency: scene geometry buffers and texture mip atlases.

The equivalent of the reference's wgpu buffer/texture/bind-group layer
(vertex/index/uniform buffers src/Renderer.zig:818-927; texture upload
src/wgpu.zig:130-194). Geometry is concatenated into flat padded arrays
(one "draw list" per scene, not per-primitive buffers — one big batched
vertex transform, not 4k draw calls); textures become one flat
linear-color mip atlas addressed by (texture id, mip, x, y).
"""

from tpurast.device.scene import DeviceScene, build_scene  # noqa: F401
from tpurast.device.textures import TextureAtlas, build_atlas  # noqa: F401
