"""filter_params_hit_share: the share of the window's finalize filter
parameter lookups that the program's device cache served (its counters
filter_params.hits, .uploads and .builds: served on the card, served by
the host cache and uploaded, computed on the host), pooled over the
window's calls, in percent; nothing where the program keeps no such
counters."""

KINDS = ("hits", "uploads", "builds")


def read(ctx):
    sums = dict.fromkeys(KINDS, 0)
    for s in ctx["stats"]:
        c = s.get("counters", {})
        for k in KINDS:
            sums[k] += c.get(f"filter_params.{k}", 0)
    total = sum(sums.values())
    return 100.0 * sums["hits"] / total if total else None
