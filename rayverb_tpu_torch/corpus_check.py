"""Acoustic comparison of two impulse-response files: what a
convolution-reverb user hears, not sample-wise equality.

    python -m rayverb_tpu_torch.corpus_check <got.wav> <reference.wav>

Two renders of one (config, model, material) with the same rays differ by
arithmetic only: another device, another order of operations. Single
arrivals then move across histogram bin edges, so a sample-wise bound
cannot hold them; the checks below measure the response's shape instead.
Each returns its reading beside its bound:

  format    equal channel count, sample rate and bit depth
  empty     both files empty (no samples or all zero) or both not
  length    sample counts within LENGTH_REL of the reference's
  decay     per channel, the Schroeder energy-decay curve (the backward
            integral of x^2, in dB relative to its start): where the
            reference's curve lies above DECAY_FLOOR_DB, max |difference|
            <= DECAY_DB
  balance   each channel's energy relative to the loudest channel's, in
            dB: max |difference| <= BALANCE_DB
  spectrum  per channel, the mean power in the 8 crossover bands
            (hrtf.table.band_energies) relative to the strongest band, in
            dB, over the bands within SPECTRUM_RANGE_DB of the reference's
            strongest: max |difference| <= SPECTRUM_DB

Host numpy only. Exit code of the command: 0 when every check holds, 1
otherwise; it prints the record as one JSON line.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from .hrtf.table import band_energies
from .io.audio import read_audio

LENGTH_REL = 0.02
DECAY_FLOOR_DB = -30.0
DECAY_DB = 1.0
BALANCE_DB = 0.5
SPECTRUM_DB = 1.0
SPECTRUM_RANGE_DB = 40.0


def _db(ratio):
    with np.errstate(divide="ignore"):
        return 10.0 * np.log10(ratio)


def _max_abs_diff(a, b) -> float:
    """max |a - b| of two dB arrays; equal infinities count as 0, an
    infinity against a finite value as +inf."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    d = np.where(same, 0.0, np.abs(a - b))
    return float(np.where(np.isnan(d), np.inf, d).max(initial=0.0))


def schroeder_db(x: np.ndarray) -> np.ndarray:
    """Energy-decay curve of one channel: 10 log10 of the backward integral
    of x^2 over its value at sample 0; -inf everywhere for silence."""
    e = np.cumsum(np.asarray(x, np.float64)[::-1] ** 2)[::-1]
    if e.size == 0 or e[0] <= 0:
        return np.full(e.shape, -np.inf)
    return _db(e / e[0])


def _is_empty(x: np.ndarray) -> bool:
    return x.size == 0 or not np.any(x)


def _check(value, bound, ok) -> dict:
    return {"value": value, "bound": bound, "ok": bool(ok)}


def compare(got, got_sr, got_bits, want, want_sr, want_bits) -> dict:
    """Compare IR ``got`` (C, N) with the reference ``want`` (C', N'),
    each with its sample rate and bit depth. Returns {"ok": bool,
    "checks": {name: {"value", "bound", "ok"} or None}}: None where a check
    does not apply (both empty, or the formats differ)."""
    got = np.atleast_2d(np.asarray(got, np.float64))
    want = np.atleast_2d(np.asarray(want, np.float64))
    checks = {
        "format": _check(
            {"channels": [got.shape[0], want.shape[0]],
             "sample_rate": [float(got_sr), float(want_sr)],
             "bit_depth": [int(got_bits), int(want_bits)]},
            "equal",
            got.shape[0] == want.shape[0] and got_sr == want_sr
            and got_bits == want_bits,
        ),
        "empty": _check([_is_empty(got), _is_empty(want)], "equal",
                        _is_empty(got) == _is_empty(want)),
    }
    shape_checks = ("length", "decay", "balance", "spectrum")
    if (not checks["format"]["ok"] or not checks["empty"]["ok"]
            or _is_empty(want)):
        checks.update(dict.fromkeys(shape_checks))
        return {"ok": all(c["ok"] for c in checks.values() if c), "checks": checks}

    n_got, n_want = got.shape[1], want.shape[1]
    length_rel = abs(n_got - n_want) / n_want
    checks["length"] = _check(length_rel, LENGTH_REL, length_rel <= LENGTH_REL)

    n = min(n_got, n_want)
    decay = 0.0
    for g, w in zip(got, want):
        edc_w = schroeder_db(w)[:n]
        above = edc_w > DECAY_FLOOR_DB
        decay = max(decay, _max_abs_diff(schroeder_db(g)[:n][above], edc_w[above]))
    checks["decay"] = _check(decay, DECAY_DB, decay <= DECAY_DB)

    e_got = np.sum(got ** 2, axis=1)
    e_want = np.sum(want ** 2, axis=1)
    balance = _max_abs_diff(_db(e_got / e_got.max()), _db(e_want / e_want.max()))
    checks["balance"] = _check(balance, BALANCE_DB, balance <= BALANCE_DB)

    spectrum = 0.0
    for g, w in zip(got, want):
        if not np.any(w):
            continue
        bw = band_energies(w, want_sr)
        bg = band_energies(g, got_sr)
        rel_w = _db(bw / bw.max())
        rel_g = _db(bg / bg.max()) if bg.max() > 0 else np.full_like(bg, -np.inf)
        kept = rel_w >= -SPECTRUM_RANGE_DB
        spectrum = max(spectrum, _max_abs_diff(rel_g[kept], rel_w[kept]))
    checks["spectrum"] = _check(spectrum, SPECTRUM_DB, spectrum <= SPECTRUM_DB)
    return {"ok": all(c["ok"] for c in checks.values()), "checks": checks}


def compare_files(got_path: str, want_path: str) -> dict:
    """compare() of two audio files (.wav/.aif[f])."""
    got, got_sr, got_bits = read_audio(got_path)
    want, want_sr, want_bits = read_audio(want_path)
    return compare(got, got_sr, got_bits, want, want_sr, want_bits)


def worst(records) -> dict:
    """The worst reading of each check over ``records`` (compare()'s
    results), beside its bound: the largest value of the numeric checks,
    and the count of failures of each."""
    out = {}
    for rec in records:
        for name, c in rec["checks"].items():
            if c is None:
                continue
            w = out.setdefault(name, {"bound": c["bound"], "failed": 0})
            w["failed"] += not c["ok"]
            if isinstance(c["value"], float):
                w["max"] = max(w.get("max", 0.0), c["value"])
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: corpus_check <got.wav> <reference.wav>", file=sys.stderr)
        return 2
    rec = compare_files(*argv)
    print(json.dumps(rec))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
