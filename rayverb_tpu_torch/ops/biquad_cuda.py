"""Wrapper of the hand-written CUDA biquad scan (csrc/biquad_scan.cu), which
runs the crossover bank's IIR recurrence on the card where the JAX package
runs lax.scan (rayverb_tpu/ops/filters.py::biquad_onepass, :157), as a
chunked parallel recurrence (one warp lane per chunk of filters.CHUNK
samples, one warp per tile of filters.TILE chunks).

The kernel is built with nvcc at first use (cuda_build) and called through
its C interface with ctypes. This module imports without nvcc or a GPU;
nothing is built until the first launch. The plain version of the kernel is
filters.biquad_onepass_plain; filters.biquad_onepass is the only caller.
"""

from __future__ import annotations

import ctypes

import torch

from .filters import CHUNK, TILE

# launches since import (or since the caller last reset it); the wrapper
# adds one per launch and nowhere else
launches = 0

_fn = None
# (device index, stream) -> (sync, agg): the kernel's chained-scan scratch,
# zero between launches (the kernel's last block clears it)
_scratch: dict = {}


def _kernel():
    global _fn
    if _fn is None:
        from ..cuda_build import load_library

        lib = load_library("biquad_scan", ["biquad_scan.cu"])
        fn = lib.rv_biquad_scan
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def build() -> None:
    """Build and load the kernel library now (it is otherwise built at the
    first launch)."""
    _kernel()


def _scratch_for(dev, stream, blocks):
    """The chained scan's scratch on ``stream``, grown to ``blocks``: a zeroed
    int32 (2 + capacity) ticket, count and flags, and (2 x capacity) float64
    aggregates. The kernel leaves it zero, so it is zeroed only when
    made."""
    key = (dev.index, stream)
    have = _scratch.get(key)
    if have is None or have[1].numel() < 2 * blocks:
        cap = max(blocks, 1024)
        have = (torch.zeros(2 + cap, dtype=torch.int32, device=dev),
                torch.empty(2 * cap, dtype=torch.float64, device=dev))
        _scratch[key] = have
    return have


def biquad_scan_cuda(data, coeffs, *, reverse: bool = False, content_len=None):
    """(S, T) float32 output of S biquad series on the current stream:
    the contract of filters.biquad_onepass_plain (series s with
    coeffs[s] = [b0, b1, b2, a1, a2]; samples [content_len, T) are 0; a
    reverse pass starts at content_len - 1). content_len: None (T), an int,
    or an (S,) int32 tensor of per-series lengths on the same device (one
    launch for all series). ``data`` (S, T) and ``coeffs`` (S, 5) must be
    contiguous float32 CUDA tensors on one device; anything else raises."""
    global launches
    if not data.is_cuda:
        raise ValueError(
            "biquad_scan_cuda needs CUDA tensors; CPU tensors go to "
            "filters.biquad_onepass_plain"
        )
    dev = data.device
    if data.dim() != 2 or data.dtype != torch.float32 or not data.is_contiguous():
        raise ValueError(f"data must be a contiguous (S, T) float32 tensor, got "
                         f"{tuple(data.shape)} {data.dtype}")
    s, t = data.shape
    if (coeffs.device != dev or coeffs.dtype != torch.float32
            or tuple(coeffs.shape) != (s, 5) or not coeffs.is_contiguous()):
        raise ValueError(f"coeffs must be a contiguous ({s}, 5) float32 tensor on "
                         f"{dev}, got {tuple(coeffs.shape)} {coeffs.dtype} on {coeffs.device}")
    contents = None
    if isinstance(content_len, torch.Tensor):
        contents = content_len
        if (contents.device != dev or contents.dtype != torch.int32
                or tuple(contents.shape) != (s,) or not contents.is_contiguous()):
            raise ValueError(f"per-series content lengths must be a contiguous ({s},) "
                             f"int32 tensor on {dev}, got {tuple(contents.shape)} "
                             f"{contents.dtype} on {contents.device}")
        if s:
            lo, hi = (int(v) for v in torch.aminmax(contents))
            if not (0 <= lo and hi <= t):
                raise ValueError(f"content lengths must lie in [0, {t}]")
        content = t
    else:
        content = t if content_len is None else int(content_len)
        if not 0 <= content <= t:
            raise ValueError(f"content_len must lie in [0, {t}], got {content}")
    blocks = s * -(-t // (CHUNK * TILE))
    if t >= 2**31 or blocks >= 2**31:
        raise ValueError(f"the kernel takes fewer than 2**31 samples and blocks, got {s} x {t}")
    out = torch.empty_like(data)
    if s == 0 or t == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        sync, agg = _scratch_for(dev, stream, blocks)
        err = fn(data.data_ptr(), out.data_ptr(), coeffs.data_ptr(), s, t,
                 content, None if contents is None else contents.data_ptr(),
                 int(bool(reverse)), sync.data_ptr(), agg.data_ptr(),
                 agg.numel() // 2, stream)
    if err != 0:
        raise RuntimeError(f"biquad scan kernel launch failed: CUDA error {err}")
    launches += 1
    return out
