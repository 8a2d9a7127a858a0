"""The port's one recorder of spans and counters, and the torch.profiler
sessions of render_fused's RAYVERB_PROFILE_DIR and the profile_render tool.

A span (``span``) names a stretch of host time; a counter (``count``) adds
to a number. Recording is on in two cases:

  - inside a call made with ``stats=True`` (``call``, the root of
    render_fused, render_irs_batched, render_fused_sharded, the modular
    pipeline's render and render_from_raw, and the CLI's render_files): the
    call's spans are kept in memory (name, start, end, parent, the call's
    id) and folded at its end into the info's ``timings``
    (``Recording.fold``). A call opened inside a recording call is a span
    of it: render_files' root rv.cli holds render_fused's rv.render, whose
    spans, counters and flat keys go into rv.cli's ``timings``
  - while a torch.profiler session records: each span then also enters a
    profiler range of its name (``_Range``), so that it lands in the same
    trace as the device's operations, on the profiler's clock. The range
    is a function-scope one: a user-scope ``record_function`` range is
    mirrored onto the device's timeline (gpu_user_annotation), where it
    would read as a device operation covering the idle gaps it names

With both off a span is one shared object that does nothing, behind one
flag check: no profiler range, no list append, no clock read, no device
synchronisation.

Whatever the switches, a small process-wide store keeps the one-time
spans (``once``: the scene load, the kernel libraries' loads) and the
whole span tree of the process's first call, whose root ends with one
device synchronisation, so that the first call's extra cost has names.

Counters: ``closest_hit.calls`` and ``closest_hit.rows`` (host),
``pair_tests.<kind>`` and ``live_rows.<kind>`` (the sweep kernel's executed
pair tests and the rows that enter it live, t_max > 0, by row kind) and
``order.entries_kept`` and ``order.entries`` (the order entries that the
order kernel's cull keeps for the sweeps to walk, and groups x nblocks),
added on the device into the call's accumulator, ``pair_sums``, and copied
to the host once, before the call's own final pull: ``stage``), ``hist.len``
and ``finalize.bucket`` (render_fused's static histogram bound and the
samples its finalize ran on), ``bounces.graph`` and ``bounces.eager``
(the trace's bounces, by replay of a CUDA graph of either phase or
eagerly) and ``bounces.image_graph`` (phase A's replays among them),
``sort_keys.fused`` and ``sort_keys.plain`` (the rows whose bounce or
shadow sort key the trace computed by the CUDA kernels of ray_keys_cuda, or
by the plain PyTorch functions),
``sweep_table.hits`` and ``sweep_table.builds`` (the scene's sweep table
taken from the process's cache or built, ops/intersect.py
``cached_soup``; the modular pipeline's Raytracer builds one every call),
``population.rows``, ``dedup.images_in`` and ``dedup.images_kept`` (the
modular pipeline's rows entering its population, and the image records
its host dedup admits and keeps), ``biquad.series_samples`` (the samples
each biquad pass of a filter bank is given: series x content length, per
pass, whatever runs it), ``filter_params.hits``, ``.uploads`` and
``.builds`` (the finalize's filter parameters served by the device cache,
by the host cache and uploaded, or computed on the host), ``write.bytes``
(the bytes of the audio files written), and
``launches.<kernel>``, the call's deltas of the module counters that the
kernel wrappers keep (LAUNCH_COUNTERS). A CUDA graph's replay adds again
the host counts that its capture added (``host_counts``, ``add_counts``).
"""

from __future__ import annotations

import itertools
import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

_profiling = torch._C._autograd._profiler_enabled
# a profiler range on the host only (module docstring)
_Range = torch._C._profiler._RecordFunctionFast

# row kinds of the sweep's accumulator (ops/trace.py SWEEP_KINDS); the
# accumulator holds the executed pair tests by kind, then the live rows by
# kind (LIVE_ROWS + kind), then the order kernel's kept entries and its
# groups x nblocks (ORDER_ENTRIES, ORDER_ENTRIES + 1): PAIR_SUMS int64s
PAIR_KINDS = ("bounce", "imgvis", "seg", "shadow")
LIVE_ROWS = len(PAIR_KINDS)
ORDER_ENTRIES = 2 * len(PAIR_KINDS)
PAIR_SUMS = ORDER_ENTRIES + 2

# counter name -> (module, attribute) of the launch counters the kernel
# wrappers keep; a module not imported yet has launched nothing
LAUNCH_COUNTERS = {
    "launches.closest_hit_sweep": ("rayverb_tpu_torch.ops.intersect_cuda", "launches"),
    "launches.closest_hit_order": ("rayverb_tpu_torch.ops.intersect_cuda", "order_launches"),
    "launches.biquad_scan": ("rayverb_tpu_torch.ops.biquad_cuda", "launches"),
    "launches.ray_keys": ("rayverb_tpu_torch.ops.ray_keys_cuda", "launches"),
}


def _launch_counts() -> dict:
    return {name: getattr(sys.modules.get(mod), attr, 0)
            for name, (mod, attr) in LAUNCH_COUNTERS.items()}


def _sync(dev):
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


_ids = itertools.count(1)


class Recording:
    """The spans and counters of one call on ``dev``. With ``stats`` its
    phases end with a device synchronisation (``phase``, ``mark``) and
    the executed pair tests are counted on the device."""

    def __init__(self, dev=None, *, stats: bool = True):
        self.id = next(_ids)
        self.dev = None if dev is None else torch.device(dev)
        self.stats = stats
        self.spans: list = []  # [name, start, end, parent index or -1, attrs]
        self.stack: list = []
        self.counters: dict = defaultdict(int)
        self.marks: dict = {}
        self.roots: list = [0]  # the span of each call open, innermost last
        self.flat: dict = {}    # the flat keys of the calls nested in this one
        self.launches0 = _launch_counts()
        self.pairs = None   # (PAIR_SUMS,) int64 on dev
        self.staged = None  # its host copy

    def open(self, name: str, start: float, attrs: dict) -> int:
        self.spans.append([name, start, None, self.stack[-1] if self.stack else -1, attrs])
        self.stack.append(len(self.spans) - 1)
        return self.stack[-1]

    def close(self, i: int, end: float):
        self.spans[i][2] = end
        # spans of other threads (parallel library builds) may close out
        # of order
        if self.stack[-1] == i:
            self.stack.pop()
        else:
            self.stack.remove(i)

    def table(self, root: int | None = None) -> dict:
        """{name: {"n", "s", "self_s"}} of the closed spans (with ``root``,
        of that span and those under it); a span's self time is its time
        less the part its child spans cover."""
        keep = None
        if root is not None:
            keep = {root}
            for j in range(root + 1, len(self.spans)):
                if self.spans[j][3] in keep:
                    keep.add(j)
        child = [0.0] * len(self.spans)
        for name, t0, t1, parent, _ in self.spans:
            if t1 is not None and parent >= 0:
                child[parent] += t1 - t0
        out: dict = {}
        for j, ((name, t0, t1, _, _), c) in enumerate(zip(self.spans, child)):
            if t1 is None or (keep is not None and j not in keep):
                continue
            row = out.setdefault(name, {"n": 0, "s": 0.0, "self_s": 0.0})
            row["n"] += 1
            row["s"] += t1 - t0
            row["self_s"] += t1 - t0 - c
        return out

    def counts(self) -> dict:
        out = dict(self.counters)
        now = _launch_counts()
        for name, n in now.items():
            out[name] = n - self.launches0.get(name, 0)
        if self.staged is not None:
            sums = self.staged.tolist()
            out.update((f"pair_tests.{k}", int(v)) for k, v in zip(PAIR_KINDS, sums))
            out.update((f"live_rows.{k}", int(v))
                       for k, v in zip(PAIR_KINDS, sums[LIVE_ROWS:]))
            out["order.entries_kept"] = int(sums[ORDER_ENTRIES])
            out["order.entries"] = int(sums[ORDER_ENTRIES + 1])
        return out

    def fold(self, flat: dict, root: int = 0) -> dict:
        """The info's ``timings`` of the call whose root is span ``root``:
        the flat keys (the marks; each key of ``flat``, and of the calls
        nested in this one, the seconds of the span it names, or the sum
        over a tuple of names, where one of them ran; ``total`` the root's),
        ``spans`` (the root's and those under it), ``counters``, ``call``
        (id and start on the host's perf_counter clock) and ``once`` (the
        process-wide store)."""
        table = self.table(root or None)
        root = self.spans[root]
        out = dict(self.marks)
        for key, names in {**self.flat, **flat}.items():
            names = (names,) if isinstance(names, str) else names
            if any(name in table for name in names):
                out[key] = sum(table[name]["s"] for name in names if name in table)
        out["total"] = root[2] - root[1]
        out["spans"] = table
        out["counters"] = self.counts()
        out["call"] = {"id": self.id, "t0": root[1]}
        out["once"] = once_record()
        return out


class _Off:
    """The span of a call that records nothing."""

    __slots__ = ()

    def set(self, **attrs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()

# the current call's Recording, or None
_current: Recording | None = None
# the process-wide store: one-time spans, and the first call's tree
_once = Recording(stats=False)
_first: dict | None = None
_first_pending = True


class _Span:
    """A recording span: opened in each Recording of ``recs``, a profiler
    range while a session records, and with ``sync`` (a device) ended by
    a synchronisation of it."""

    __slots__ = ("name", "attrs", "recs", "sync", "rf", "ids", "t0")

    def __init__(self, name, attrs, recs, sync=None):
        self.name, self.attrs, self.recs, self.sync = name, attrs, recs, sync
        self.rf = None

    def set(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self):
        if _profiling():
            self.rf = _Range(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        self.ids = [r.open(self.name, self.t0, self.attrs) for r in self.recs]
        return self

    def __exit__(self, *exc):
        if self.sync is not None and exc[0] is None:
            _sync(self.sync)
        t1 = time.perf_counter()
        for r, i in zip(self.recs, self.ids):
            r.close(i, t1)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, /, **attrs):
    """A span of the current call (a context manager); the shared no-op
    when nothing records."""
    if _current is None:
        if not _profiling():
            return _OFF
        return _Span(name, attrs, ())
    return _Span(name, attrs, (_current,))


def phase(name: str, /, **attrs):
    """A span that, in a ``stats`` call, ends with a synchronisation of the
    call's device, so that its time holds the device work it enqueued."""
    rec = _current
    if rec is None:
        return span(name, **attrs)
    return _Span(name, attrs, (rec,), rec.dev if rec.stats else None)


def once(name: str, /, **attrs):
    """A one-time span: kept in the process-wide store whatever the
    switches (and in the current call's tree); its ``set`` adds
    attributes."""
    recs = (_once,) if _current is None else (_once, _current)
    return _Span(name, attrs, recs)


def count(name: str, n: int = 1):
    """Add ``n`` to the current call's counter ``name``."""
    if _current is not None:
        _current.counters[name] += n


def counting() -> bool:
    """Whether ``count`` adds to a call's counters now: a counter whose
    value costs a device synchronisation is computed only then."""
    return _current is not None


def host_counts() -> dict:
    """The host's counters now: the kernel wrappers' launch counters
    (LAUNCH_COUNTERS) and the current call's counters."""
    out = _launch_counts()
    if _current is not None:
        out.update(_current.counters)
    return out


def add_counts(delta: dict):
    """Add ``delta``, a difference of two host_counts, to the counters
    again: what a replayed CUDA graph launches and counts, which its
    capture counted once."""
    for name, n in delta.items():
        if name in LAUNCH_COUNTERS:
            mod, attr = LAUNCH_COUNTERS[name]
            module = sys.modules[mod]
            setattr(module, attr, getattr(module, attr) + n)
        else:
            count(name, n)


def mark(key: str):
    """In a ``stats`` call: synchronise its device and keep the seconds
    since the root of the innermost call began as the flat timing
    ``key``."""
    rec = _current
    if rec is not None and rec.stats:
        _sync(rec.dev)
        rec.marks[key] = time.perf_counter() - rec.spans[rec.roots[-1]][1]


def pair_sums():
    """The current ``stats`` call's sweep accumulator, a (PAIR_SUMS,)
    int64 tensor on its device, zeroed once per call: the executed pair
    tests by row kind, the live rows by row kind, then the order kernel's
    kept entries and entries; None when the call counts none."""
    rec = _current
    if rec is None or not rec.stats or rec.dev is None:
        return None
    if rec.pairs is None:
        rec.pairs = torch.zeros((PAIR_SUMS,), dtype=torch.int64, device=rec.dev)
    return rec.pairs


def stage():
    """Enqueue the one copy of the current call's accumulator to the host;
    the call's own final pull (or phase synchronisation) completes it."""
    rec = _current
    if rec is None or rec.pairs is None:
        return
    if rec.pairs.is_cuda:
        rec.staged = torch.empty(rec.pairs.shape, dtype=rec.pairs.dtype, pin_memory=True)
        rec.staged.copy_(rec.pairs, non_blocking=True)
    else:
        rec.staged = rec.pairs.clone()


def once_record() -> dict:
    """The process-wide store: ``spans`` (one-time spans by name) and
    ``first`` (the process's first call: its root's name, id, start and
    seconds, its spans and counters), or None before it ends."""
    return {"spans": _once.table(), "first": _first}


@contextmanager
def call(name: str, dev, /, *, stats: bool = False, timings: dict | None = None,
         flat: dict | None = None, **attrs):
    """The root span ``name`` of one call on ``dev``. With ``stats`` the
    call records, and at its end its Recording.fold(flat) goes into
    ``timings``. The process's first call records too, and its root ends
    with one device synchronisation. A call inside a recording call is a
    span of it and opens no Recording of its own; inside a ``stats`` call
    its flat keys join the outer call's, and with ``stats`` the fold of
    its own span and those under it goes into ``timings``. A ``stats``
    call inside a call that records without stats (the process's first)
    records on its own."""
    global _current, _first, _first_pending
    outer = _current
    if outer is not None and (outer.stats or not stats):
        with span(name, **attrs) as sp:
            outer.roots.append(sp.ids[0])
            try:
                yield
            finally:
                outer.roots.pop()
        if outer.stats:
            outer.flat.update(flat or {})
            if stats and timings is not None:
                timings.update(outer.fold(flat or {}, root=sp.ids[0]))
        return
    first = _first_pending and outer is None
    if not (stats or first):
        with span(name, **attrs):
            yield
        return
    rec = Recording(dev, stats=stats)
    _current = rec
    if first:
        _first_pending = False
    done = False
    try:
        with span(name, **attrs):
            yield
            if first:
                _sync(rec.dev)
        done = True
    finally:
        _current = outer
        if first and not done:
            _first_pending = True
    if first:
        root = rec.spans[0]
        _first = {"name": name, "id": rec.id, "t0": root[1], "s": root[2] - root[1],
                  "spans": rec.table(), "counters": rec.counts()}
    if stats and timings is not None:
        timings.update(rec.fold(flat or {}))


def report(timings: dict) -> list:
    """Lines of a call's span table (n, total and self seconds by name,
    the largest total first) and its counters."""
    lines = [f"{'span':<20} {'n':>7} {'total s':>9} {'self s':>9}"]
    rows = sorted(timings.get("spans", {}).items(), key=lambda kv: -kv[1]["s"])
    lines += [f"{k:<20} {v['n']:>7} {v['s']:>9.4f} {v['self_s']:>9.4f}" for k, v in rows]
    counters = timings.get("counters", {})
    if counters:
        lines.append("counters: " + "  ".join(f"{k}={v}" for k, v in sorted(counters.items())))
    return lines


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
