"""Batched IR datagen (PyTorch counterpart of rayverb_tpu/parallel)."""

from .datagen import render_irs_batched, trim_batch

__all__ = ["render_irs_batched", "trim_batch"]
