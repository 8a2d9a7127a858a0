"""Entry ``render_fused``: one impulse response per call, the render
document's source and mic, one direction set of the seed's per call.

The harness reads, by the traffic's ``entry`` name: FUNCTION (a
"module:function" string), ``setup``, ``pairs``, ``make_input``, ``call``
and ``reference``."""

import numpy as np

from portbench import inputs

FUNCTION = "rayverb_tpu_torch.ops.render:render_fused"


def setup(cell):
    pass


def pairs(cell) -> int:
    return 1


def make_input(cell, seed: int, index: int):
    return inputs.directions(1, cell.rays, inputs.unit_seed(seed, index), cell.dev)[0]


def call(fn, cell, x, stats: bool):
    """(the call's responses on the host, (C, L) each; its info)"""
    channels, info = fn(cell.scene, cell.cfg, x, hrtf_table=cell.table, impl=cell.impl,
                        device=cell.dev, stats=stats)
    return [np.asarray(channels)], (info or {})


def reference(ref, x, orders, tick):
    """Per response of the call, the reference's (C, L) under each ray order."""
    one = lambda key: np.asarray([ref.doc[key]], np.float32)  # noqa: E731
    outs = ref.render(one("source_position"), one("mic_position"), x[None], orders, tick)
    return [[o[0] for o in outs]]
