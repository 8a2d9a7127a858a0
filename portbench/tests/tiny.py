"""Each cell cut to a size the CPU tests can run with the plain sweep."""

TINY = {
    "vault.render": {"render": {"rays": 256, "reflections": 12}, "pool": 2, "profile": 1},
    "hall100k.hrtf": {"render": {"rays": 256, "reflections": 4}, "pool": 2, "profile": 1},
    "vault.datagen": {"render": {"rays": 128, "reflections": 6}, "pairs": 3, "pool": 2,
                      "profile": 1},
}
SEED = (1 << 33) + 17


def run(cell, trace=False, **kw):
    from portbench import harness

    overrides = {**TINY[cell], **kw.pop("overrides", {})}
    return harness.run_cell(cell, kw.pop("seed", SEED), 0.0, trace, device="cpu",
                            impl="plain", overrides=overrides, **kw)
