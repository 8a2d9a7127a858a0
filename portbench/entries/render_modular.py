"""Entry ``render_modular``: the modular pipeline (``--pipeline modular``,
pipeline.render) with its causal scan filters, one impulse response per
call, the render document's source and mic, one direction set of the
seed's per call (as entries/render_fused.py makes them). Its reference is
reference/modular.py: per-arrival predelay, the histogram sized by the
last arrival, the Linkwitz-Riley bank's four passes. See render_fused.py
for what the harness reads here."""

import numpy as np

from portbench.entries.render_fused import make_input, pairs, setup  # noqa: F401
from portbench.reference import modular

FUNCTION = "rayverb_tpu_torch.pipeline:render"
FILTER_METHOD = "scan"


def call(fn, cell, x, stats: bool):
    """(the call's responses on the host, (C, L) each; its info)"""
    result = fn(cell.cfg, cell.scene, directions=x, hrtf_table=cell.table,
                filter_method=FILTER_METHOD, trace_impl=cell.impl, device=cell.dev,
                stats=stats)
    return [np.asarray(result.channels)], result.info


def reference(ref, x, orders, tick):
    """Per response of the call, the modular reference's (C, L) under each
    ray order."""
    one = lambda key: np.asarray([ref.doc[key]], np.float32)  # noqa: E731
    outs = modular.render(ref.scene, ref.doc, one("source_position"), one("mic_position"),
                          x[None], ref.table, tick=tick, orders=orders)
    return [[o[0] for o in outs]]
