"""The biquad scan kernel of this checkout against another checkout's, in
turns on one card.

    python -m rayverb_tpu_torch.biquad_ab PARENT

PARENT is the root of the other checkout (e.g. a parent commit unpacked
with ``git archive`` into the ignored ``_checkout/``). Its
``rayverb_tpu_torch/csrc/biquad_scan.cu`` is built with this checkout's
nvcc flags into PARENT/rayverb_tpu_torch/_build/, and its own wrapper
(``ops/biquad_cuda.py``) is loaded on that library, so each side pays its
own wrapper's host cost. Prints one JSON object per line:

- ``card``: nvidia-smi's name and power limit.
- ``shape``: for each pass shape (the modular vault's 16 x 122,248, the
  vault's longest series 16 x 524,288, and the 8-pair datagen scan
  finalize's 128 x 32,768 with per-pair lengths), forward and reverse, on
  the vault's Linkwitz-Riley coefficients: whether this checkout's kernel
  equals its plain version (filters.biquad_onepass_plain, on the card)
  bit for bit, the two kernels' largest difference over the peak, and in
  the turns parent, change, change, parent the device ms per launch
  (torch.profiler) and the ms per call (CUDA events, wrapper included),
  with chip_smoke.py's timing helpers.

Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from unittest import mock

TURNS = ("parent", "change", "change", "parent")

# (series, samples, per-series lengths or None): the modular vault's pass,
# the vault's longest series, the datagen scan finalize's pass (8 pairs x 2
# ears x 8 bands, each pair its own content length)
SHAPES = ((16, 122_248, None), (16, 524_288, None), (128, 32_768, "pairs"))
REPS = 20


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _parent_wrapper(parent):
    """The other checkout's biquad_scan_cuda (ops/biquad_cuda.py) on its
    own kernel library: its csrc/biquad_scan.cu built with this checkout's
    nvcc flags into PARENT/rayverb_tpu_torch/_build/."""
    from . import cuda_build

    src = os.path.join(parent, "rayverb_tpu_torch", "csrc", "biquad_scan.cu")
    out_dir = os.path.join(parent, "rayverb_tpu_torch", "_build")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "biquad_ab_parent.so")
    proc = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", lib_path, src],
        capture_output=True, text=True, timeout=cuda_build.NVCC_TIMEOUT_S,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    so = ctypes.CDLL(lib_path)
    spec = importlib.util.spec_from_file_location(
        "rayverb_tpu_torch.ops._ab_parent_biquad_cuda",
        os.path.join(parent, "rayverb_tpu_torch", "ops", "biquad_cuda.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # its _kernel() binds its own argument types on the library it loads
    with mock.patch.object(cuda_build, "load_library", lambda *a: so):
        mod._kernel()
    return mod.biquad_scan_cuda


def _smoke():
    """chip_smoke.py at the checkout's root, for its timing helpers and
    inputs; importing it runs nothing."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(series, samples, lengths, rng, smoke):
    """Band signals, the vault's first two passes' coefficients (forward,
    then reverse) and the pass's content lengths: None, or one length per
    pair of 16 series, drawn as the datagen batch's contents spread
    (4,000-13,000 samples) with 0, 1 and full among them."""
    import numpy as np
    import torch

    x = torch.from_numpy(smoke._band_signals(rng, series, samples)).cuda()
    passes = smoke._vault_scan_passes(torch.device("cuda"), channels=series // 8)[:2]
    lens = None
    if lengths == "pairs":
        pairs = series // 16
        per_pair = rng.integers(4_000, 13_000, pairs)
        per_pair[:3] = (0, 1, samples)
        lens = torch.from_numpy(np.repeat(per_pair, 16).astype(np.int32)).cuda()
    return x, passes, lens


def run(parent):
    import numpy as np
    import torch

    from .device import card_name_and_power
    from .ops import biquad_cuda
    from .ops.filters import biquad_onepass_plain

    if not torch.cuda.is_available():
        raise RuntimeError("biquad_ab needs a CUDA device")
    smoke = _smoke()
    _emit({"card": card_name_and_power(), "torch_device": torch.cuda.get_device_name(0)})
    wrap = {"parent": _parent_wrapper(parent), "change": biquad_cuda.biquad_scan_cuda}
    rng = np.random.default_rng(3)
    for series, samples, lengths in SHAPES:
        x, passes, lens = _inputs(series, samples, lengths, rng, smoke)
        for coeffs, reverse in passes:
            def call(w):
                return lambda: wrap[w](x, coeffs, reverse=reverse, content_len=lens)

            got = {w: wrap[w](x, coeffs, reverse=reverse, content_len=lens) for w in wrap}
            plain = biquad_onepass_plain(x, coeffs, reverse=reverse, content_len=lens)
            torch.cuda.synchronize()
            peak = float(plain.abs().max())
            rec = {
                "shape": [series, samples], "reverse": reverse,
                "lengths": None if lens is None else sorted(set(lens.tolist())),
                "change_equals_plain": bool(torch.equal(got["change"].view(torch.int32),
                                                        plain.view(torch.int32))),
                "parent_vs_change_max_err_over_peak":
                    float((got["parent"] - got["change"]).abs().max()) / peak,
                "device_ms": [[w, smoke._profiled_ms(call(w), "biquad_scan", REPS)]
                              for w in TURNS],
                "call_ms": [[w, smoke._cuda_ms(call(w), REPS)] for w in TURNS],
                **smoke._biquad_bounds(series, samples,
                                       None if lens is None else int(lens.sum())),
            }
            _emit(rec)
            if not rec["change_equals_plain"]:
                raise AssertionError(f"the kernel differs from its plain version: {rec}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: biquad_ab PARENT", file=sys.stderr)
        return 2
    run(argv[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
