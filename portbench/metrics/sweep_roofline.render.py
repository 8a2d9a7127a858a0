"""sweep_roofline.render: the least time the closest-hit queries of one IR
could take on the card, over the device time of the kernels that answer
them (KERNELS), in percent.

The least time is by bytes alone, counted from the cell's inputs and not
from the kernel: for each reflection every ray's bounce query and its mic
shadow query read an origin, a direction and a bound (28 B) and write a
hit (t and triangle, 8 B); each of the 1 + 2R sweeps reads the triangle
table once (three float32 vertices, 36 B a triangle). No operation count
enters: the tests a closest hit needs depend on the acceleration structure.
The bytes go over the card's HBM bandwidth from portbench/peaks.json."""

import json
import os

KERNELS = ("closest_hit_sweep", "closest_hit_order")
QUERY_BYTES = 28 + 8
TRIANGLE_BYTES = 36


def read(ctx):
    prof = ctx["profile"]
    if prof is None:
        return None
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "peaks.json")) as fh:
        peak = json.load(fh).get(ctx["device_kind"])
    seconds = prof.kernel_s(KERNELS) / prof.units
    if peak is None or seconds <= 0:
        return None
    n, r, t = ctx["rays"], ctx["reflections"], ctx["triangles"]
    nbytes = 2 * n * r * QUERY_BYTES + (1 + 2 * r) * t * TRIANGLE_BYTES
    return 100.0 * nbytes / peak["hbm_bytes_per_s"] / seconds
