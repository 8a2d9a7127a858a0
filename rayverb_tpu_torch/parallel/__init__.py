"""Multi-rank rendering and batched IR datagen (PyTorch counterpart of
rayverb_tpu/parallel)."""

from .datagen import render_irs_batched, trim_batch
from .sharded import make_mesh, render_fused_sharded, shard_rays

__all__ = ["make_mesh", "render_fused_sharded", "shard_rays", "render_irs_batched",
           "trim_batch"]
