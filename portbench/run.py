"""Run one cell of the port bench on the card this process is started on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with --trace 1 its per-layer metrics), ``device``, with --trace 1 a
``breakdown``, and last ``checks``, each number that decides ``correct``
beside its limit (also the last lines of standard error). Exits non-zero
and prints no result when no CUDA card (or fewer than the cell asks for)
is visible, when the run stalls (no progress for STALL_S seconds), or when
JAX or the JAX package was loaded into the process.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")
# every build and kernel cache at a fixed path inside the checkout; the
# program's own nvcc cache is rayverb_tpu_torch/_build/
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host's thread pools stay out of the way
# of the host path that feeds the card
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

STALL_S = 150.0


class Watchdog:
    """Ends the process (exit code 3) when ``tick`` has not been called for
    ``limit`` seconds, so a wedged run fails instead of hanging."""

    def __init__(self, limit: float):
        self.limit = limit
        self.last = time.monotonic()
        threading.Thread(target=self._watch, daemon=True).start()

    def tick(self):
        self.last = time.monotonic()

    def _watch(self):
        while True:
            time.sleep(1.0)
            idle = time.monotonic() - self.last
            if idle > self.limit:
                print(f"portbench: no progress for {idle:.0f} s; stopping", file=sys.stderr,
                      flush=True)
                os._exit(3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    watchdog = Watchdog(STALL_S)

    sys.path.insert(0, ROOT)
    from portbench import harness

    spec = harness.load_spec()
    parts = harness.resolve(spec, args.workload)
    cell = parts["cell"]
    harness.apply_env(parts["traffic"])  # before the program is imported

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"visible: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_process=T_PROCESS, spec=spec,
                              progress=watchdog.tick)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
