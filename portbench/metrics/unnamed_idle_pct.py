"""unnamed_idle_pct: the device's idle time in gaps whose middle falls in
no stage of portbench/stages.py (a call root's own time, the trace's own
code between its phases, time between calls), in percent of the profiled
window's wall, the base device_idle_pct divides by: the stage idles times
the calls plus this share give device_idle_pct. Nothing where the program
keeps no stage spans or no device operation was profiled."""

from portbench.stages import idle_by_stage


def read(ctx):
    prof = ctx.get("profile")
    sums = idle_by_stage(prof)
    if sums is None or prof.wall_s <= 0:
        return None
    return 100.0 * sums[None] / prof.wall_s
