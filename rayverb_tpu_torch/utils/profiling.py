"""torch.profiler sessions shared by render_fused's RAYVERB_PROFILE_DIR and
the profile_render tool."""

from __future__ import annotations

import os
import time
from contextlib import contextmanager


def profiler(cuda: bool = True):
    """torch.profiler.profile with CPU activities, and CUDA's with
    ``cuda``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


@contextmanager
def trace_into(directory: str, dev):
    """Profile the block (CUDA activities on a CUDA ``dev``) and write its
    Chrome trace into ``directory`` (made if missing) as
    render-<pid>-<ns>.json: render_fused's RAYVERB_PROFILE_DIR."""
    os.makedirs(directory, exist_ok=True)
    with profiler(dev.type == "cuda") as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        directory, f"render-{os.getpid()}-{time.time_ns()}.json"))
