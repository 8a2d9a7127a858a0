"""first_call_extra_s: seconds the process's first call (the warm-up, the
root span the program keeps of it, ended by a device sync) took beyond the
median call of the window (its ``timings["total"]``). Nothing where the
program keeps no such record, or where that first call began before this
run did (a process that ran other calls first)."""

import statistics


def read(ctx):
    stats = [s for s in ctx["stats"] if "total" in s and "call" in s and "once" in s]
    if not stats:
        return None
    first = stats[0]["once"].get("first")
    # the run began setup_s before its first timed call
    if not first or first["t0"] < stats[0]["call"]["t0"] - ctx["setup_s"]:
        return None
    return first["s"] - statistics.median(s["total"] for s in stats)
