"""rayverb_tpu_torch: the PyTorch/CUDA port of rayverb_tpu.

The JAX package ``rayverb_tpu`` stays the reference. This package mirrors
its module names and computes the same renders (the fused one and the
modular pipeline) with PyTorch tensors; the one TPU kernel on their path,
the closest-hit sweep, is a hand-written CUDA kernel here
(csrc/closest_hit.cu), and so is the filter bank's biquad scan, a chunked
parallel recurrence where the JAX package runs lax.scan
(csrc/biquad_scan.cu). It imports
nothing of JAX and nothing of ``rayverb_tpu``.
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

__version__ = "0.1.0"
