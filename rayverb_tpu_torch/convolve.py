"""Listening demo: convolve a dry sample with a rendered impulse response.

    python -m rayverb_tpu_torch.convolve ir.wav dry.wav out.wav [--wet 1.0]
        [--dry-gain 0.0] [--bit-depth 16] [--device cuda|cpu]
    python -m rayverb_tpu_torch.convolve ir.wav --click out.wav
    python -m rayverb_tpu_torch.convolve ir.wav --burst out.wav

The port's counterpart of scripts/convolve.py: overlap-free FFT
convolution (torch.fft.rfft / irfft in float64 on the device) of a dry
WAV/AIFF, a unit impulse (--click) or a 0.3 s decaying noise burst
(--burst) with the IR, normalised to the dry signal's peak, mixed with
--dry-gain of the dry signal and clipped to [-1, 1]. Mono signals fan out
to the other's channel count; otherwise the counts must match.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def synth(kind: str, sample_rate: float) -> np.ndarray:
    """(1, 0.35 s) dry signal: 'click' (a unit impulse) or 'burst' (noise
    from default_rng(5) under a 50 ms exponential envelope, peak 1)."""
    n = int(0.35 * sample_rate)
    t = np.arange(n) / sample_rate
    if kind == "click":
        sig = np.zeros(n, np.float32)
        sig[0] = 1.0
    else:
        rng = np.random.default_rng(5)
        env = np.exp(-t / 0.05)
        sig = (rng.standard_normal(n) * env).astype(np.float32)
        sig /= np.abs(sig).max()
    return sig[None, :]


def convolve(ir, dry):
    """FFT convolution per channel pair of float64 tensors on one device:
    (C, Ti) x (C, Td) -> (C, Ti + Td - 1)."""
    import torch

    out_len = ir.shape[1] + dry.shape[1] - 1
    nfft = 1 << (out_len - 1).bit_length()
    spec = torch.fft.rfft(ir, n=nfft) * torch.fft.rfft(dry, n=nfft)
    return torch.fft.irfft(spec, n=nfft)[:, :out_len]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("ir", help="rendered impulse response (.wav/.aif)")
    parser.add_argument("dry", nargs="?", help="dry sample to convolve")
    parser.add_argument("output", help="output audio file")
    parser.add_argument("--click", action="store_true",
                        help="use a synthetic unit impulse as the dry signal")
    parser.add_argument("--burst", action="store_true",
                        help="use a 0.3 s decaying noise burst")
    parser.add_argument("--wet", type=float, default=1.0)
    parser.add_argument("--dry-gain", type=float, default=0.0)
    parser.add_argument("--bit-depth", type=int, default=16)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    import torch

    from .device import resolve_device
    from .io.audio import read_audio, write_audio

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    ir, ir_sr, _ = read_audio(args.ir)
    ir = np.atleast_2d(np.asarray(ir, np.float64))
    if args.click or args.burst:
        dry = synth("click" if args.click else "burst", ir_sr).astype(np.float64)
        dry_sr = ir_sr
    else:
        if args.dry is None:
            parser.error("provide a dry sample or --click/--burst")
        dry, dry_sr, _ = read_audio(args.dry)
        dry = np.atleast_2d(np.asarray(dry, np.float64))
    if abs(dry_sr - ir_sr) > 1e-6:
        print(f"warning: sample-rate mismatch (ir {ir_sr}, dry {dry_sr}); "
              "output uses the IR's rate", file=sys.stderr)

    c = max(ir.shape[0], dry.shape[0])
    if ir.shape[0] == 1:
        ir = np.repeat(ir, c, axis=0)
    if dry.shape[0] == 1:
        dry = np.repeat(dry, c, axis=0)
    if ir.shape[0] != dry.shape[0]:
        parser.error(f"channel mismatch: ir {ir.shape[0]} vs dry {dry.shape[0]}")

    dry_t = torch.from_numpy(dry).to(dev)
    wet = convolve(torch.from_numpy(ir).to(dev), dry_t)
    peak = wet.abs().max()
    if peak > 0:
        wet = wet / peak * dry_t.abs().max()
    out = args.wet * wet
    if args.dry_gain:
        out[:, : dry.shape[1]] += args.dry_gain * dry_t
    out = out.clamp(-1.0, 1.0).cpu().numpy()

    write_audio(args.output, out.astype(np.float32), ir_sr, args.bit_depth)
    print(f"wrote {args.output}: {out.shape[0]} ch x {out.shape[1]} samples "
          f"@ {ir_sr:g} Hz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
