"""pathtracer_tpu_torch: the PyTorch + CUDA (Hopper) port of pathtracer_tpu.

The JAX package ``pathtracer_tpu`` is the reference; this package mirrors
its module names (``utils/``, ``scene/``, ``ops/``, ``render/``, ``io/``,
``cli.py``) and draws the same PCG4D random streams, so each port function
can be held against its JAX counterpart. It imports torch and numpy and
never JAX. The render loop runs as one hand-written CUDA kernel
(``csrc/wave_kernel.cu``) on CUDA tensors and as its plain PyTorch version
on CPU tensors.
"""

__version__ = "0.1.0"

from .scene.schema import (  # noqa: F401
    MAX_BOUNCE_COUNT, Scene, WorldBuilder,
    WORLD_DEFAULT, WORLD_BRDF_TEST, WORLD_CORNELL_BOX,
    WORLD_RAYTRACING_ONE_WEEKEND, WORLD_MARIO,
    WORLD_CORNELL_QUAD, WORLD_MESH_UV,
)
from .scene.worlds import build_world, finalize_world  # noqa: F401
from .scene.camera import Camera, define_camera  # noqa: F401
from .render.renderer import RenderConfig, render_image  # noqa: F401
