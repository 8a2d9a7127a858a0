"""The closest-hit sweep against an independent float64 oracle.

    python -m rayverb_tpu_torch.kernel_parity [--rays 2048] [--seed 3]
        [--device cuda|cpu] [--log PATH]

chip_smoke.py holds the CUDA kernel bit for bit to its plain version,
which shares its arithmetic (Woop rows in float32). This holds it to
something that shares none of it: a float64 brute-force Moller-Trumbore
sweep with the reference's tolerances (kernel.cpp:62-88,161-192; a copy
of scripts/kernel_parity.py's numpy_reference written for tensors on any
device, chunked over triangles). The rows are those of
scripts/kernel_parity.py: random origins in the middle 60 % of the scene's
bounds and random directions from default_rng(seed), a third open
closest-hit rows, a third bounded point-to-point rows (t_max) and a third
bounded any-hit rows (t_max and t_decide), on the vault (vault.json
materials) and on the 101,568-triangle hall of scripts/gen_hall.py,
generated into a temporary directory.

Gates (scripts/kernel_parity.py's, the float64 oracle in the place of the
XLA float32 sweep), over the exact rows (the first two thirds):
  - hit agreement 1.0
  - relative t error on rows both hit: p99 < 2e-5, max < 5e-4
  - an index that differs from the oracle's is a coplanar tie: the
    oracle's own t for the returned triangle lies within 2e-4 of its best
  - index agreement >= 0.9 (the vault's overlapping coplanar faces)
and over the any-hit rows, whose contract is the verdict only:
  - visibility verdicts (no hit, or hit beyond the point) agree at 1.0

On cuda the sweep is the CUDA kernel (intersect.closest_hit launches it
for CUDA tensors; the record counts its launches), on cpu its plain
version. Prints one JSON record (with the card's name and power limit on
cuda), writes it to --log too, and exits 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch

from .constants import EPSILON
from .ops.intersect import closest_hit, soup_from_scene
from .probe import hall_scene

# bytes of float64 intermediates per (ray, triangle) pair of the oracle:
# a few (., ., 3) vectors and (., .) planes
PAIR_BYTES = 256
CHUNK_BYTES = 256 << 20
GATES = {
    "hit_agree": 1.0,
    "p99_t_rel_err": 2e-5,
    "max_t_rel_err": 5e-4,
    "index_mismatch_max_t_rel": 2e-4,
    "index_agree": 0.9,
    "decide_verdict_agree": 1.0,
}


def _cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _mt(o, d, v0, e0, e1, eps):
    """Float64 Moller-Trumbore t of broadcast rays and triangles, +inf
    where there is no hit beyond eps."""
    pv = _cross(d, e1)
    det = _dot(e0, pv)
    deg = det.abs() < eps
    inv = 1.0 / torch.where(deg, 1.0, det)
    tv = o - v0
    u = inv * _dot(tv, pv)
    qv = _cross(tv, e0)
    v = inv * _dot(d, qv)
    t = inv * _dot(e1, qv)
    ok = ~deg & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > eps)
    return torch.where(ok, t, torch.inf)


def oracle(o, d, v0, e0, e1, t_max=None, eps=EPSILON, chunk_bytes=CHUNK_BYTES):
    """Closest hit (t (M,) float64, index (M,) int64, -1 = none) of rays
    (M, 3) against triangles (T, 3) in float64 on the tensors' device,
    lowest index on ties, t_max inclusive; triangles in chunks of at most
    ``chunk_bytes`` of intermediates."""
    o, d, v0, e0, e1 = (x.to(torch.float64) for x in (o, d, v0, e0, e1))
    n = o.shape[0]
    bt = torch.full((n,), torch.inf, dtype=torch.float64, device=o.device)
    bi = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    step = max(1, chunk_bytes // (PAIR_BYTES * max(n, 1)))
    for s0 in range(0, v0.shape[0], step):
        sl = slice(s0, s0 + step)
        t = _mt(o[:, None], d[:, None], v0[None, sl], e0[None, sl], e1[None, sl], eps)
        ti = torch.argmin(t, dim=1)
        tm = t.gather(1, ti[:, None])[:, 0]
        upd = tm < bt
        bt = torch.where(upd, tm, bt)
        bi = torch.where(upd, ti + s0, bi)
    if t_max is not None:
        inside = bt <= t_max.to(torch.float64)
        bt = torch.where(inside, bt, torch.inf)
        bi = torch.where(inside, bi, -1)
    return bt, bi


def pair_t(o, d, v0, e0, e1, index, eps=EPSILON):
    """Float64 t of each ray (M, 3) against its own triangle ``index``
    (M,), +inf where it misses."""
    return _mt(*(x.to(torch.float64) for x in (o, d, v0[index], e0[index], e1[index])), eps)


def sweep_rows(bounds, nrays: int, seed: int) -> dict:
    """scripts/kernel_parity.py's rows (numpy float32): origins, unit
    directions, t_max, t_decide, the point distance ``mag``, and the
    exact-row mask (all but the last third)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(bounds)
    center = 0.5 * (lo + hi)
    span = np.maximum(hi - lo, 1.0)
    o = (center + (rng.random((nrays, 3)) - 0.5) * 0.6 * span).astype(np.float32)
    d = rng.normal(size=(nrays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    third = nrays // 3
    mag = (0.3 + 0.6 * np.linalg.norm(span) * rng.random(nrays)).astype(np.float32)
    t_max = np.full(nrays, np.inf, np.float32)
    t_max[third:] = mag[third:] * 1.001 + 0.01
    decide = np.zeros(nrays, np.float32)
    decide[2 * third:] = mag[2 * third:]
    exact = np.ones(nrays, bool)
    exact[2 * third:] = False
    return {"o": o, "d": d, "t_max": t_max, "decide": decide, "mag": mag, "exact": exact}


def gates(got_t, got_i, got_hit, ref_t, ref_i, tie_t, mag, exact) -> dict:
    """The gates' readings (module docstring) from numpy arrays: the
    sweep's (t, index, hit), the oracle's (t, index; -1 = none), the
    oracle's t of the sweep's own triangle per row (``tie_t``), the point
    distances and the exact-row mask. Returns the readings and "ok"."""
    ref_hit = ref_i >= 0
    both = exact & got_hit & ref_hit
    same = got_i[both] == ref_i[both]
    rel = np.abs(got_t[both] - ref_t[both]) / np.maximum(ref_t[both], 1e-9)
    mism = both.copy()
    mism[both] = ~same
    tie = np.abs(tie_t[mism] - ref_t[mism]) / np.maximum(ref_t[mism], 1e-9)
    tie = np.where(np.isnan(tie), np.inf, tie)  # inf - inf: the triangle misses
    dec = ~exact
    vis_ref = ~ref_hit[dec] | (ref_t[dec] > mag[dec])
    vis_got = ~got_hit[dec] | (got_t[dec] > mag[dec])
    out = {
        "hit_agree": float((got_hit[exact] == ref_hit[exact]).mean()),
        "index_agree": float(same.mean()) if same.size else 1.0,
        "max_t_rel_err": float(rel.max(initial=0.0)),
        "p99_t_rel_err": float(np.percentile(rel, 99)) if rel.size else 0.0,
        "index_mismatches": int(mism.sum()),
        "index_mismatch_max_t_rel": float(tie.max(initial=0.0)),
        "decide_verdict_agree": float((vis_got == vis_ref).mean()) if dec.any() else 1.0,
    }
    out["ok"] = bool(
        out["hit_agree"] >= GATES["hit_agree"]
        and out["p99_t_rel_err"] < GATES["p99_t_rel_err"]
        and out["max_t_rel_err"] < GATES["max_t_rel_err"]
        and out["index_mismatch_max_t_rel"] < GATES["index_mismatch_max_t_rel"]
        and out["index_agree"] >= GATES["index_agree"]
        and out["decide_verdict_agree"] >= GATES["decide_verdict_agree"]
    )
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_scene(name: str, scene, nrays: int, seed: int, device) -> dict:
    """Sweep ``nrays`` rows (sweep_rows) of ``scene`` on ``device`` and
    hold them to the float64 oracle on the same device. Returns the
    record; its "ok" is the gates'."""
    from .ops import intersect_cuda

    dev = torch.device(device)
    soup = soup_from_scene(scene, device=dev)
    rows = sweep_rows(scene.bounds, nrays, seed)
    o, d, t_max, decide = (torch.from_numpy(rows[k]).to(dev)
                           for k in ("o", "d", "t_max", "decide"))
    launches = intersect_cuda.launches
    _sync(dev)
    t0 = time.perf_counter()
    hit = closest_hit(o, d, soup, t_max=t_max, t_decide=decide)
    _sync(dev)
    sweep_s = time.perf_counter() - t0
    launches = intersect_cuda.launches - launches
    t0 = time.perf_counter()
    ref_t, ref_i = oracle(o, d, soup.v0, soup.e0, soup.e1, t_max)
    tie_t = pair_t(o, d, soup.v0, soup.e0, soup.e1, hit.index)
    _sync(dev)
    oracle_s = time.perf_counter() - t0
    host = lambda x: x.cpu().numpy()  # noqa: E731
    vs = gates(host(hit.t).astype(np.float64), host(hit.index), host(hit.hit),
               host(ref_t), host(ref_i), host(tie_t), rows["mag"], rows["exact"])
    ok = vs.pop("ok")
    return {
        "scene": name,
        "triangles": int(soup.v0.shape[0]),
        "table_rows": soup.num_padded,
        "rays": nrays,
        "seed": seed,
        "impl": "cuda" if dev.type == "cuda" else "plain",
        "kernel_launches": launches,
        "vs_float64": vs,
        "gates": GATES,
        "sweep_s": sweep_s,
        "oracle_s": oracle_s,
        "ok": ok,
    }


def vault_scene():
    from .profile_render import VAULT
    from .scene import load_scene

    return load_scene(*VAULT[1:])


def run(nrays: int, seed: int, device) -> dict:
    """Both scenes' records (the vault with ``seed``, the hall with
    ``seed + 1``, as scripts/kernel_parity.py) and the device's name."""
    dev = torch.device(device)
    rec = {"device": str(dev), "torch": torch.__version__}
    if dev.type == "cuda":
        from .device import card_name_and_power

        rec["card"] = card_name_and_power()
        rec["torch_device"] = torch.cuda.get_device_name(dev)
    with tempfile.TemporaryDirectory(prefix="rayverb_parity_") as tmp:
        hall = hall_scene(tmp)
    rec["scenes"] = [
        check_scene("vault", vault_scene(), nrays, seed, dev),
        check_scene("hall100k", hall, nrays, seed + 1, dev),
    ]
    rec["ok"] = all(s["ok"] for s in rec["scenes"])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--log", metavar="PATH", default=None,
                    help="also write the record to PATH")
    args = ap.parse_args(argv)
    from .device import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    text = json.dumps(run(args.rays, args.seed, dev), indent=1)
    print(text)
    if args.log:
        with open(args.log, "w") as fh:
            fh.write(text + "\n")
    return 0 if json.loads(text)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
