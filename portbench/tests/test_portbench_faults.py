"""The comparison that decides ``correct`` fails what it must: the control
(the reference computed in bfloat16, put in the program's place) and the
faults a cell can have, planted under the timed path of a whole run at a
tiny size on the CPU (the harness's look for a card skipped). One card
carries no exchange between chips, so that fault has no cell here."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference.render import RAY_ORDERS

from .tiny import SEED, TINY, run

CELLS = sorted(TINY)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    c = harness.Cell(cell, device="cpu", impl="plain", overrides=TINY[cell])
    ref = harness.Reference(c.parts, c.doc, c.dev)
    low = harness.Reference(c.parts, c.doc, c.dev, dtype=torch.bfloat16)
    limit = c.parts["checks"]["ir_rel_err"]["limit"]
    for index in range(2):
        x = c.inputs(SEED, index)
        got = [cands[0] for cands in c.adapter.reference(low, x, RAY_ORDERS[-1:], None)]
        err = harness.compare([got], [c.adapter.reference(ref, x, RAY_ORDERS, None)])
        assert err > limit


def _stale(entry):
    """A call that returns its state unchanged: the previous call's answer."""
    last = []

    def call(*args, **kw):
        out = entry(*args, **kw)
        last.append(out)
        return last[-2] if len(last) > 1 else out

    return call


def _half_batch(entry, batched):
    """Half of the batch left out: half the rays of a render; half the
    pairs of a batch, the others' responses left empty."""
    def call(scene, cfg, *x, **kw):
        if not batched:
            (dirs,) = x
            return entry(scene, cfg, dirs[: len(dirs) // 2], **kw)
        srcs, mics, dirs = x
        half = len(srcs) // 2
        out = entry(scene, cfg, srcs[:half], mics[:half], dirs[:half], **kw)
        irs = torch.zeros((len(srcs),) + tuple(out[0].shape[1:]))
        irs[:half] = out[0]
        contents = torch.zeros(len(srcs), dtype=out[1].dtype)
        contents[:half] = out[1]
        return (irs, contents) + tuple(out[2:])

    return call


def _altered(entry, batched):
    """An answer altered where it is produced: the first channel at 0.9."""
    def call(*args, **kw):
        out = entry(*args, **kw)
        if batched:
            out[0][:, 0] *= 0.9
            return out
        ch, info = out
        ch = np.array(ch)
        ch[0] *= 0.9
        return ch, info

    return call


@pytest.mark.parametrize("fault", ["stale", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_correct_false(cell, fault):
    name = harness.resolve(harness.load_spec(), cell)["traffic"]["entry"]
    batched = name == "render_irs_batched"
    entry = harness.function(harness.entry(name).FUNCTION)
    planted = {"stale": lambda: _stale(entry), "half_batch": lambda: _half_batch(entry, batched),
               "altered": lambda: _altered(entry, batched)}[fault]()
    r = run(cell, program=planted, overrides={"warmup": 2})
    assert r["correct"] is False
    assert r["failed"] > 0
    assert r["checks"]["ir_rel_err"]["value"] > r["checks"]["ir_rel_err"]["limit"]
