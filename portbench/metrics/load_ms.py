"""load_ms: milliseconds of the CLI render's flat wall ``load`` (spans
rv.config and rv.load_scene: the config's parse and the scene's OBJ parse
and compile), median over the window's calls; nothing where the program
keeps no such key."""

import statistics

KEY = "load"


def read(ctx):
    xs = [s[KEY] for s in ctx["stats"] if KEY in s]
    return 1e3 * statistics.median(xs) if xs else None
