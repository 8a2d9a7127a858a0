"""rayverb_tpu_torch: the PyTorch/CUDA port of rayverb_tpu.

The JAX package ``rayverb_tpu`` stays the reference. This package mirrors
its module names and computes what it computes with PyTorch tensors: the
fused render and the modular pipeline, batched IR datagen, the render
sharded over ranks of ``torch.distributed`` (``parallel``), the scene
loaders with the native OBJ parser, and the CLI. The one TPU kernel, the
closest-hit sweep, is a hand-written CUDA kernel here
(csrc/closest_hit.cu), and so is the filter bank's biquad scan, a chunked
parallel recurrence where the JAX package runs lax.scan
(csrc/biquad_scan.cu). It imports nothing of JAX and nothing of
``rayverb_tpu``.
"""

from .constants import NUM_BANDS, NUM_IMAGE_SOURCE, SPEED_OF_SOUND
from .config.schema import (
    AttenuationModel,
    ConfigError,
    FilterType,
    HrtfConfig,
    OutputMode,
    RenderConfig,
    Speaker,
    load_config,
    parse_config,
)
from .scene.compile import Scene, SceneError, compile_scene, load_scene
from .scene.materials import SurfaceSet, load_materials, parse_materials
from .scene.objloader import RawMesh, load_mesh, load_obj

__version__ = "0.1.0"

__all__ = [
    "NUM_BANDS",
    "NUM_IMAGE_SOURCE",
    "SPEED_OF_SOUND",
    "AttenuationModel",
    "ConfigError",
    "FilterType",
    "HrtfConfig",
    "OutputMode",
    "RenderConfig",
    "Speaker",
    "load_config",
    "parse_config",
    "Scene",
    "SceneError",
    "compile_scene",
    "load_scene",
    "SurfaceSet",
    "load_materials",
    "parse_materials",
    "RawMesh",
    "load_mesh",
    "load_obj",
    "__version__",
]
