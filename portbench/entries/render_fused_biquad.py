"""Entry ``render_fused_biquad``: render_fused's calls and inputs, as
entries/render_fused.py makes them, held to the reference with the biquad
crossovers (reference/biquad.py: the one-pass and two-pass band-pass
banks, and "hipass": false read as the default cutoff)."""

import numpy as np

from portbench.entries.render_fused import FUNCTION, call, make_input, pairs, setup  # noqa: F401
from portbench.reference import biquad


def reference(ref, x, orders, tick):
    """Per response of the call, the biquad reference's (C, L) under each
    ray order."""
    one = lambda key: np.asarray([ref.doc[key]], np.float32)  # noqa: E731
    outs = biquad.render(ref.scene, ref.doc, one("source_position"), one("mic_position"),
                         x[None], ref.table, tick=tick, orders=orders)
    return [[o[0] for o in outs]]
