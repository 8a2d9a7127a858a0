"""The readings that a cell's limits are set from (not run by the benchmark's
own runs).

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --control 3 \
        [--first 5000] [--out chiprun_out/calibrate.jsonl]

In one process on the card: the program's relative difference from the
float32 reference on the first input of each of ``--seeds`` seeds (the
lower reading is their largest), and the control's, the reference computed
in bfloat16 (in the Morton ray order) put in the program's place, on the
first ``--control`` of them (the upper reading is their smallest). Prints one JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first", type=int, default=5000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--overrides", default="{}", help="JSON: traffic keys to replace")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(HERE))
    import torch

    from portbench import harness

    from portbench.reference.render import RAY_ORDERS

    harness.apply_env(harness.resolve(harness.load_spec(), args.workload)["traffic"])
    impl = "auto" if args.device == "cuda" else "plain"
    cell = harness.Cell(args.workload, device=args.device, impl=impl,
                        overrides=json.loads(args.overrides))
    ref = harness.Reference(cell.parts, cell.doc, cell.dev)
    control = harness.Reference(cell.parts, cell.doc, cell.dev, dtype=torch.bfloat16)
    out = open(args.out, "a") if args.out else None
    for i in range(args.seeds):
        seed = args.first + i
        x = cell.inputs(seed, 0)
        t0 = time.perf_counter()
        got, _ = cell.call(x)
        t1 = time.perf_counter()
        want = cell.adapter.reference(ref, x, RAY_ORDERS, harness._noop)
        t2 = time.perf_counter()
        rows = [{"kind": "program", "ir_rel_err": harness.compare([got], [want]),
                 "program_s": t1 - t0, "reference_s": t2 - t1}]
        if i < args.control:
            # the control renders in the program's place, in its ray order
            low = [c[-1] for c in cell.adapter.reference(control, x, RAY_ORDERS[-1:],
                                                          harness._noop)]
            rows.append({"kind": "control", "ir_rel_err": harness.compare([low], [want]),
                         "control_s": time.perf_counter() - t2})
        for row in rows:
            line = json.dumps({"cell": args.workload, "seed": seed, **row})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
