"""biquad_roofline.modular: the least time the filter bank's biquad passes
of one IR could take on the card, over the device time of the kernel that
runs them (KERNELS), in percent.

The least time is by bytes alone, counted from the program's counter
biquad.series_samples (the samples every pass is given: series x content
length, added whatever kernel runs the pass), not from the kernel: each
sample of each pass is read once and written once as float32
(``pass_bytes``). The recurrence's operations do not enter: the bound a
scan meets first is the memory's. The bytes go over the card's HBM
bandwidth from portbench/peaks.json; the counter is the median over the
window's calls, the time the profiled calls' mean. Nothing where the
program keeps no such counter or no such kernel ran."""

import json
import os
import statistics

KERNELS = ("biquad_scan",)
COUNTER = "biquad.series_samples"
SAMPLE_BYTES = 4 + 4


def pass_bytes(series_samples: int) -> int:
    """Bytes the passes must move: each sample read and written, float32."""
    return SAMPLE_BYTES * series_samples


def read(ctx):
    prof = ctx["profile"]
    counts = [s["counters"][COUNTER] for s in ctx["stats"]
              if s.get("counters", {}).get(COUNTER)]
    if prof is None or not counts:
        return None
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "peaks.json")) as fh:
        peak = json.load(fh).get(ctx["device_kind"])
    seconds = prof.kernel_s(KERNELS) / prof.units
    if peak is None or seconds <= 0:
        return None
    least = pass_bytes(statistics.median(counts)) / peak["hbm_bytes_per_s"]
    return 100.0 * least / seconds
