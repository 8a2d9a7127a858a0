"""The demo corpus through the port: every (config, model, material)
combination of the reference's demo/gen.sh (the table of scripts/gen.py),
rendered in one process through rayverb_tpu_torch.cli's render_files.

    python -m rayverb_tpu_torch.gen --outdir DIR [--ext wav] [--limit N]
        [--only MODEL] [--pipeline fused|modular] [--seed S] [--dry-run]
        [--check-against REFDIR] [--device cuda|cpu] [--stats]

Writes DIR/<model>/<model>_<config>_<material>.<ext> and DIR/report.json.
Render k of the full COMBOS list gets ``--seed S + k`` whatever --only and
--limit keep, so a filtered re-render traces the same rays as the whole
corpus's file (the JAX package's corpus, impulses/, was rendered with
S = 0). With --check-against each render is held against
REFDIR/<model>/<model>_<config>_<material>.<ext> by corpus_check, its
readings go into the report, and any failed check makes the exit code 1,
as any failed render does. Each render's record has its seed, wall,
channels and samples, and "cold" for the first render of the run, "warm"
for the others; with --stats also its flat timings (load: config and
scene, render, write, and the render's own, trace_bin and finalize for the
fused render) under "timings", and its sweep-table and filter-parameter
cache counters (sweep_table.hits, .builds, filter_params.hits, .uploads,
.builds) under "counters". DIR may not be the repository's impulses/,
the JAX package's checked-in corpus.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "impulses")

# (config, model, material), in scripts/gen.py's order (demo/gen.sh:21-199)
COMBOS = [
    ('hrtf_vault', 'random_pillars', 'mat'),
    ('hrtf_vault_l', 'random_pillars', 'mat'),
    ('hrtf_vault_r', 'random_pillars', 'mat'),
    ('oct', 'random_pillars', 'mat'),
    ('near_c', 'echo_tunnel', 'mat'),
    ('far', 'echo_tunnel', 'mat'),
    ('bedroom', 'bedroom', 'mat'),
    ('near_c', 'small_square', 'mat'),
    ('near_c', 'large_pentagon', 'mat'),
    ('far', 'large_pentagon', 'mat'),
    ('vault', 'vault', 'vault'),
    ('vault_l', 'vault', 'vault'),
    ('vault_r', 'vault', 'vault'),
    ('hrtf_vault', 'vault', 'vault'),
    ('hrtf_vault_l', 'vault', 'vault'),
    ('hrtf_vault_r', 'vault', 'vault'),
    ('near_c', 'bedroom', 'mat'),
    ('near_l', 'bedroom', 'mat'),
    ('near_r', 'bedroom', 'mat'),
    ('near_c', 'random_pillars', 'mat'),
    ('near_l', 'random_pillars', 'mat'),
    ('near_r', 'random_pillars', 'mat'),
    ('medium', 'random_pillars', 'mat'),
    ('far_2', 'random_pillars', 'mat'),
    ('near_c', 'small_triangle', 'mat'),
    ('near_l', 'small_triangle', 'mat'),
    ('near_r', 'small_triangle', 'mat'),
    ('near_l', 'small_square', 'mat'),
    ('near_r', 'small_square', 'mat'),
    ('near_c', 'small_pentagon', 'mat'),
    ('near_l', 'small_pentagon', 'mat'),
    ('near_r', 'small_pentagon', 'mat'),
    ('near_c', 'small_heptagon', 'mat'),
    ('near_l', 'small_heptagon', 'mat'),
    ('near_r', 'small_heptagon', 'mat'),
    ('near_c', 'medium_triangle', 'mat'),
    ('near_l', 'medium_triangle', 'mat'),
    ('near_r', 'medium_triangle', 'mat'),
    ('near_c', 'medium_square', 'mat'),
    ('near_l', 'medium_square', 'mat'),
    ('near_r', 'medium_square', 'mat'),
    ('near_c', 'medium_pentagon', 'mat'),
    ('near_l', 'medium_pentagon', 'mat'),
    ('near_r', 'medium_pentagon', 'mat'),
    ('near_c', 'medium_heptagon', 'mat'),
    ('near_l', 'medium_heptagon', 'mat'),
    ('near_r', 'medium_heptagon', 'mat'),
    ('near_c', 'large_triangle', 'mat'),
    ('near_l', 'large_triangle', 'mat'),
    ('near_r', 'large_triangle', 'mat'),
    ('near_c', 'large_square', 'mat'),
    ('near_l', 'large_square', 'mat'),
    ('near_r', 'large_square', 'mat'),
    ('near_l', 'large_pentagon', 'mat'),
    ('near_r', 'large_pentagon', 'mat'),
    ('near_c', 'large_heptagon', 'mat'),
    ('near_l', 'large_heptagon', 'mat'),
    ('near_r', 'large_heptagon', 'mat'),
    ('medium', 'medium_triangle', 'mat'),
    ('medium', 'medium_square', 'mat'),
    ('medium', 'medium_pentagon', 'mat'),
    ('medium', 'medium_heptagon', 'mat'),
    ('medium', 'large_triangle', 'mat'),
    ('medium', 'large_square', 'mat'),
    ('medium', 'large_pentagon', 'mat'),
    ('medium', 'large_heptagon', 'mat'),
    ('far', 'large_triangle', 'mat'),
    ('far', 'large_square', 'mat'),
    ('far', 'large_heptagon', 'mat'),
    ('near_c', 'small_triangle', 'damped'),
    ('near_l', 'small_triangle', 'damped'),
    ('near_r', 'small_triangle', 'damped'),
    ('near_c', 'small_square', 'damped'),
    ('near_l', 'small_square', 'damped'),
    ('near_r', 'small_square', 'damped'),
    ('near_c', 'small_pentagon', 'damped'),
    ('near_l', 'small_pentagon', 'damped'),
    ('near_r', 'small_pentagon', 'damped'),
    ('near_c', 'small_heptagon', 'damped'),
    ('near_l', 'small_heptagon', 'damped'),
    ('near_r', 'small_heptagon', 'damped'),
    ('near_c', 'medium_triangle', 'damped'),
    ('near_l', 'medium_triangle', 'damped'),
    ('near_r', 'medium_triangle', 'damped'),
    ('near_c', 'medium_square', 'damped'),
    ('near_l', 'medium_square', 'damped'),
    ('near_r', 'medium_square', 'damped'),
    ('near_c', 'medium_pentagon', 'damped'),
    ('near_l', 'medium_pentagon', 'damped'),
    ('near_r', 'medium_pentagon', 'damped'),
    ('near_c', 'medium_heptagon', 'damped'),
    ('near_l', 'medium_heptagon', 'damped'),
    ('near_r', 'medium_heptagon', 'damped'),
    ('near_c', 'large_triangle', 'damped'),
    ('near_l', 'large_triangle', 'damped'),
    ('near_r', 'large_triangle', 'damped'),
    ('near_c', 'large_square', 'damped'),
    ('near_l', 'large_square', 'damped'),
    ('near_r', 'large_square', 'damped'),
    ('near_c', 'large_pentagon', 'damped'),
    ('near_l', 'large_pentagon', 'damped'),
    ('near_r', 'large_pentagon', 'damped'),
    ('near_c', 'large_heptagon', 'damped'),
    ('near_l', 'large_heptagon', 'damped'),
    ('near_r', 'large_heptagon', 'damped'),
    ('medium', 'medium_triangle', 'damped'),
    ('medium', 'medium_square', 'damped'),
    ('medium', 'medium_pentagon', 'damped'),
    ('medium', 'medium_heptagon', 'damped'),
    ('medium', 'large_triangle', 'damped'),
    ('medium', 'large_square', 'damped'),
    ('medium', 'large_pentagon', 'damped'),
    ('medium', 'large_heptagon', 'damped'),
    ('far', 'large_triangle', 'damped'),
    ('far', 'large_square', 'damped'),
    ('far', 'large_pentagon', 'damped'),
    ('far', 'large_heptagon', 'damped'),
    ('near_c', 'small_triangle', 'bright'),
    ('near_c', 'small_square', 'bright'),
    ('near_c', 'small_pentagon', 'bright'),
    ('near_c', 'small_heptagon', 'bright'),
    ('near_c', 'medium_triangle', 'bright'),
    ('near_c', 'medium_square', 'bright'),
    ('near_c', 'medium_pentagon', 'bright'),
    ('near_c', 'medium_heptagon', 'bright'),
    ('near_c', 'large_triangle', 'bright'),
    ('near_c', 'large_square', 'bright'),
    ('near_c', 'large_pentagon', 'bright'),
    ('near_c', 'large_heptagon', 'bright'),
    ('medium', 'medium_triangle', 'bright'),
    ('medium', 'medium_square', 'bright'),
    ('medium', 'medium_pentagon', 'bright'),
    ('medium', 'medium_heptagon', 'bright'),
    ('medium', 'large_triangle', 'bright'),
    ('medium', 'large_square', 'bright'),
    ('medium', 'large_pentagon', 'bright'),
    ('medium', 'large_heptagon', 'bright'),
    ('far', 'large_triangle', 'bright'),
    ('far', 'large_square', 'bright'),
    ('far', 'large_pentagon', 'bright'),
    ('far', 'large_heptagon', 'bright'),
    ('near_c', 'small_triangle', 'brighter'),
    ('near_c', 'small_square', 'brighter'),
    ('near_c', 'small_pentagon', 'brighter'),
    ('near_c', 'small_heptagon', 'brighter'),
    ('near_c', 'medium_triangle', 'brighter'),
    ('near_c', 'medium_square', 'brighter'),
    ('near_c', 'medium_pentagon', 'brighter'),
    ('near_c', 'medium_heptagon', 'brighter'),
    ('near_c', 'large_triangle', 'brighter'),
    ('near_c', 'large_square', 'brighter'),
    ('near_c', 'large_pentagon', 'brighter'),
    ('near_c', 'large_heptagon', 'brighter'),
    ('medium', 'medium_triangle', 'brighter'),
    ('medium', 'medium_square', 'brighter'),
    ('medium', 'medium_pentagon', 'brighter'),
    ('medium', 'medium_heptagon', 'brighter'),
    ('medium', 'large_triangle', 'brighter'),
    ('medium', 'large_square', 'brighter'),
    ('medium', 'large_pentagon', 'brighter'),
    ('medium', 'large_heptagon', 'brighter'),
    ('far', 'large_triangle', 'brighter'),
    ('far', 'large_square', 'brighter'),
    ('far', 'large_pentagon', 'brighter'),
    ('far', 'large_heptagon', 'brighter'),
]


def combo_name(combo) -> str:
    config, model, material = combo
    return f"{model}_{config}_{material}"


def combo_paths(combo):
    """(config, model, materials) paths of a combination in assets/."""
    config, model, material = combo
    return (
        os.path.join(REPO, "assets", "configs", f"{config}.json"),
        os.path.join(REPO, "assets", "test_models", f"{model}.obj"),
        os.path.join(REPO, "assets", "materials", f"{material}.json"),
    )


def select(only=None, limit=None):
    """(k, combo) pairs to render: k is the index in the full COMBOS list,
    which sets the seed."""
    todo = [(k, c) for k, c in enumerate(COMBOS) if only is None or c[1] == only]
    return todo[:limit] if limit else todo


def covering():
    """The combinations, in COMBOS order, each of which brings a config,
    model or material that no earlier one of them brought: every config,
    model and material at least once. Returns (k, combo) pairs."""
    seen = [set(), set(), set()]
    out = []
    for k, combo in enumerate(COMBOS):
        if any(part not in s for part, s in zip(combo, seen)):
            out.append((k, combo))
            for part, s in zip(combo, seen):
                s.add(part)
    return out


def walls_by_model(renders) -> dict:
    """Median, min and max render wall (s) per model over report records."""
    import statistics

    walls = {}
    for r in renders:
        walls.setdefault(COMBOS[r["index"]][1], []).append(r["wall_s"])
    return {m: {"renders": len(w), "median_s": statistics.median(w), "min_s": min(w),
                "max_s": max(w)} for m, w in walls.items()}


# the cache counters a --stats record keeps (utils/profiling.py)
CACHE_COUNTERS = ("sweep_table.hits", "sweep_table.builds", "filter_params.hits",
                  "filter_params.uploads", "filter_params.builds")


def render(todo, outdir, *, ext="wav", pipeline="fused", seed=0, device="cuda",
           check_against=None, stats=False, log=print):
    """Render the (k, combo) pairs of ``todo`` into ``outdir`` through the
    port's CLI render (cli.render_files) in this process; with
    ``check_against`` hold each against its file there. With ``stats``
    each record gains its flat ``timings`` (load, render, write and the
    render's own, e.g. trace_bin and finalize) and its cache ``counters``
    (CACHE_COUNTERS). Returns the report (scripts/gen.py's keys and the
    per-render records)."""
    from . import cli
    from .corpus_check import compare_files, worst
    from .io.audio import AudioFormatError

    records = []
    t_start = time.time()
    for i, (k, combo) in enumerate(todo):
        name = combo_name(combo)
        out = os.path.join(outdir, combo[1], f"{name}.{ext}")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        log(f"[{i + 1}/{len(todo)}] {combo[1]} x {combo[0]} x {combo[2]} (seed {seed + k})")
        rec = {"combo": name, "index": k, "seed": seed + k,
               "run": "cold" if i == 0 else "warm"}
        stderr = io.StringIO()
        t0 = time.perf_counter()
        # the CLI's checks and error texts (cli.main), kept in the record
        paths = combo_paths(combo)
        with contextlib.redirect_stderr(stderr):
            error, _ = cli.precheck(*paths, out)
            try:
                if error is None:
                    channels, info = cli.render_files(*paths, out, pipeline=pipeline,
                                                      seed=seed + k, device=device,
                                                      stats=stats)
            except (ValueError, RuntimeError, OSError) as e:
                error = f"encountered runtime error:\n{e}"
            if error is not None:
                print(error, file=sys.stderr)
            rc = 0 if error is None else 1
        rec["wall_s"] = time.perf_counter() - t0
        rec["rc"] = rc
        if rc != 0:
            rec["error"] = stderr.getvalue().strip()
            log(f"  FAILED (rc={rc}): {rec['error']}")
        else:
            rec["channels"], rec["samples"] = int(channels.shape[0]), int(channels.shape[1])
            if stats:
                timings = info["timings"]
                rec["timings"] = {k: v for k, v in timings.items()
                                  if isinstance(v, float) and k != "total"}
                rec["counters"] = {k: timings["counters"].get(k, 0) for k in CACHE_COUNTERS}
            if check_against is not None:
                try:
                    rec["check"] = compare_files(
                        out, os.path.join(check_against, combo[1], f"{name}.{ext}"))
                except (OSError, AudioFormatError) as e:  # missing or unreadable
                    rec["check"] = {"ok": False, "checks": {}, "error": str(e)}
                if not rec["check"]["ok"]:
                    bad = [n for n, c in rec["check"]["checks"].items() if c and not c["ok"]]
                    log(f"  CHECK FAILED: {bad}")
        records.append(rec)
    wall = time.time() - t_start
    failed = [r["combo"] for r in records if r["rc"] != 0]
    report = {
        "rendered": len(todo) - len(failed),
        "failures": len(failed),
        "failed_combos": failed,
        "total": len(todo),
        "wall_seconds": round(wall, 1),
        "per_render_seconds": [round(r["wall_s"], 2) for r in records],
        "pipeline": pipeline,
        "mode": "in-process",
        "ext": ext,
        "device": device,
        "walls_by_model": walls_by_model(records),
        "renders": records,
    }
    if check_against is not None:
        checked = [r["check"] for r in records if "check" in r]
        report["check_against"] = check_against
        report["check_failed_combos"] = [
            r["combo"] for r in records if "check" in r and not r["check"]["ok"]]
        report["check_worst"] = worst(checked)
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--ext", default="wav", choices=("wav", "aif", "aiff"))
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--only", default=None, help="filter by model name")
    parser.add_argument("--pipeline", default="fused", choices=("fused", "modular"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--check-against", metavar="REFDIR", default=None,
                        help="hold each render against REFDIR's file of the "
                             "same name (corpus_check)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--stats", action="store_true",
                        help="keep each render's flat timings and cache counters "
                             "in its record")
    args = parser.parse_args(argv)
    if os.path.realpath(args.outdir) == os.path.realpath(CORPUS):
        parser.error(f"--outdir may not be {CORPUS}: it holds the JAX "
                     "package's corpus")

    from .device import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1

    todo = select(args.only, args.limit)
    if args.dry_run:
        for i, (k, combo) in enumerate(todo):
            print(f"[{i + 1}/{len(todo)}] {combo[1]} x {combo[0]} x {combo[2]} "
                  f"(seed {args.seed + k})")
        return 0
    report = render(todo, args.outdir, ext=args.ext, pipeline=args.pipeline,
                    seed=args.seed, device=args.device,
                    check_against=args.check_against, stats=args.stats,
                    log=lambda s: print(s, flush=True))
    os.makedirs(args.outdir, exist_ok=True)
    with open(os.path.join(args.outdir, "report.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"done: {report['rendered']}/{report['total']} rendered in "
          f"{report['wall_seconds']:.0f}s"
          + (f"; {len(report['check_failed_combos'])} failed the check"
             if args.check_against is not None else ""))
    failed_check = report.get("check_failed_combos")
    return 1 if report["failures"] or failed_check else 0


if __name__ == "__main__":
    sys.exit(main())
