"""On the card: the sort-key kernels (csrc/ray_keys.cu, ops/ray_keys_cuda.py)
against their plain versions (ops/trace.py ``_ray_sort_key`` and
``_dir_morton`` through ``_signed32``), key for key and bit for bit, at the
vault's 50,000 rows and the north star's 1,048,576: random rows and the
edge cases (+-0, positions landing exactly on 0 and 511 of the grid and
just inside, positions outside the bounds, axis directions, dead rows), the
multi-pair shadow key at 64 pairs, and both kernels replayed from a
captured CUDA graph against eager launches. Then whole traces: the vault
through ``_trace_impl`` with the kernels against the plain keys (and
against ``impl="plain"``, its phase A the same fixed-shape bounce run
without a graph), rows and counters equal. This file imports no JAX; on
the card run

    python -m pytest --noconftest -m card tests/test_torch_ray_keys_card.py

Each test skips without a CUDA card."""

import functools
import pathlib

import numpy as np
import pytest
import torch

from rayverb_tpu_torch.config.schema import load_config
from rayverb_tpu_torch.constants import NUM_IMAGE_SOURCE
from rayverb_tpu_torch.ops import intersect, ray_keys_cuda, trace
from rayverb_tpu_torch.scene import load_scene
from rayverb_tpu_torch.utils import profiling
from rayverb_tpu_torch.utils.directions import random_directions

ASSETS = pathlib.Path(__file__).resolve().parent.parent / "assets"
SIZES = (50_000, 1_048_576)
# (lo, span) of the position grid: power-of-two spans, where rows land
# exactly on 0 and 511, and the spans of an arbitrary box
BOUNDS = {"pow2": ([-2.0, -1.0, 0.5], [16.0, 8.0, 8.0]),
          "box": ([-2.0, -1.0, 0.5], [12.0, 7.5, 9.0])}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the sort-key kernels run on the card only")
    return torch.device("cuda")


def _edge_dirs():
    rows = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
            [0.0, -0.0, 1.0], [-0.0, -0.0, -1.0], [0.6, -0.0, 0.8], [-0.0, 0.8, -0.6]]
    rows += [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    d = torch.tensor(rows, dtype=torch.float32)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def _inputs(n, bounds, seed, dev):
    """(pos, d, lo, inv_span) on ``dev``: positions over twice the box
    around it, directions uniform, the edge rows first."""
    rng = np.random.default_rng(seed)
    lo = torch.tensor(BOUNDS[bounds][0])
    span = torch.tensor(BOUNDS[bounds][1])
    inv_span = 1.0 / torch.clamp(span, min=1e-6)
    hi = lo + span
    pos = torch.from_numpy(rng.uniform(-0.5, 1.5, (n, 3)).astype(np.float32)) * span + lo
    below = torch.nextafter(hi, lo)
    edge = [lo, hi, below, torch.nextafter(hi, hi + 1), torch.nextafter(lo, lo - 1),
            torch.nextafter(lo, hi), (lo + hi) / 2, torch.tensor([0.0, -0.0, 0.0]),
            torch.tensor([-0.0, -0.0, -0.0]), lo - span, hi + span,
            torch.stack([lo[0], hi[1], below[2]])]
    pos[: len(edge)] = torch.stack(edge)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    e = _edge_dirs()
    d[: e.shape[0]] = e
    d[e.shape[0]: 2 * e.shape[0]] = -e
    return tuple(x.to(dev) for x in (pos, d, lo, inv_span))


def _plain_bounce(pos, d, lo, inv_span):
    return trace._signed32(trace._ray_sort_key(pos, d, lo, inv_span))


@pytest.mark.card
@pytest.mark.parametrize("bounds", sorted(BOUNDS))
@pytest.mark.parametrize("n", SIZES)
def test_bounce_key_equals_plain(card, n, bounds):
    pos, d, lo, inv_span = _inputs(n, bounds, n + len(bounds), card)
    assert torch.isfinite(pos).all() and torch.isfinite(d).all()
    got = ray_keys_cuda.bounce_key_cuda(pos, d, lo, inv_span)
    want = _plain_bounce(pos, d, lo, inv_span)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    # the top bit of the uint32 key is exercised both ways
    assert (got < 0).any() and (got >= 0).any()
    if bounds == "pow2":
        q = (pos[:3] - lo) * inv_span * 511.0
        assert (q[0] == 0).all() and (q[1] == 511).all() and (q[2] < 511).all()
    if n == SIZES[0]:
        cpu = _plain_bounce(*(x.cpu() for x in (pos, d, lo, inv_span)))
        assert torch.equal(got.cpu(), cpu)


@pytest.mark.card
@pytest.mark.parametrize("pairs", [None, 64])
@pytest.mark.parametrize("n", SIZES)
def test_shadow_key_equals_plain(card, n, pairs):
    _, d, _, _ = _inputs(n, "box", 3 * n, card)
    gen = torch.Generator(device="cpu").manual_seed(n)
    alive = (torch.rand(n, generator=gen) < 0.7).to(card)
    alive[:8] = False
    pair = (None if pairs is None else
            (torch.arange(n) * pairs // n).to(card))
    assert torch.isfinite(d).all()
    got = ray_keys_cuda.shadow_key_cuda(d, alive, pair)
    want = trace._shadow_key(d, alive, pair, "plain")
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == (torch.int32 if pair is None else torch.int64)
    assert torch.equal(got, want)
    perm = torch.argsort(got, stable=True)
    assert torch.equal(perm, torch.argsort(want, stable=True))
    if pair is None:
        dead = int((~alive).sum())
        assert not alive[perm[-dead:]].any()


@pytest.mark.card
def test_keys_replayed_from_a_graph(card):
    """Both kernels captured in one CUDA graph over static inputs: each
    replay reads the inputs as they are then, as eager launches do."""
    n = SIZES[0]
    pos, d, lo, inv_span = _inputs(n, "box", 5, card)
    alive = torch.arange(n, device=card) % 5 != 0
    pair = torch.arange(n, device=card) // 1024
    # the library loaded and its kernels launched once outside the capture
    ray_keys_cuda.bounce_key_cuda(pos, d, lo, inv_span)
    ray_keys_cuda.shadow_key_cuda(d, alive, pair)
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin()
        outs = (ray_keys_cuda.bounce_key_cuda(pos, d, lo, inv_span),
                ray_keys_cuda.shadow_key_cuda(d, alive, None),
                ray_keys_cuda.shadow_key_cuda(d, alive, pair))
        graph.capture_end()
    torch.cuda.current_stream(card).wait_stream(stream)
    for seed in (6, 7):
        new = _inputs(n, "box", seed, card)
        for buf, x in zip((pos, d), new):
            buf.copy_(x)
        alive.copy_(torch.roll(alive, seed))
        before = ray_keys_cuda.launches
        graph.replay()
        assert ray_keys_cuda.launches == before  # a replay launches nothing from the host
        want = (ray_keys_cuda.bounce_key_cuda(pos, d, lo, inv_span),
                ray_keys_cuda.shadow_key_cuda(d, alive, None),
                ray_keys_cuda.shadow_key_cuda(d, alive, pair))
        torch.cuda.synchronize()
        for got, w in zip(outs, want):
            assert torch.equal(got, w)
        assert torch.equal(outs[0], _plain_bounce(pos, d, lo, inv_span))


class _EagerGraph(trace._BounceGraph):
    """The runner without a graph: nothing is captured, and each step runs
    the bounce on the static state into fixed row buffers."""

    def _capture(self):
        pass

    def _replay(self):
        row = self.chain()
        if self.row is None:
            self.row = tuple(torch.empty_like(x) for x in row)
        for buf, x in zip(self.row, row):
            buf.copy_(x)


@functools.lru_cache(maxsize=None)
def _vault_soup():
    scene = load_scene(str(ASSETS / "test_models" / "vault.obj"),
                       str(ASSETS / "materials" / "vault.json"))
    return intersect.soup_from_scene(scene, device="cuda")


def _trace(monkeypatch, way, pairs=None, rays=4096, reflections=NUM_IMAGE_SOURCE + 3):
    """(rows, image slots, pair sums, counters) of a vault trace with
    resort; ``way``: 'fused' (the kernels), 'plain_keys' (the plain keys,
    the kernels' sweeps), 'plain' (impl='plain' throughout)."""
    cfg = load_config(str(ASSETS / "configs" / "vault.json"))
    soup = _vault_soup()
    if pairs is None:
        mic, src, pair_id = cfg.mic_position, cfg.source_position, None
        dirs = random_directions(rays, seed=31)
    else:
        rng = np.random.default_rng(8)
        lo, hi = (soup.bounds[0].cpu().numpy(), soup.bounds[1].cpu().numpy())
        mic = (lo + (hi - lo) * (0.3 + 0.4 * rng.random((pairs, 3)))).astype(np.float32)
        src = (lo + (hi - lo) * (0.3 + 0.4 * rng.random((pairs, 3)))).astype(np.float32)
        dirs = np.concatenate([random_directions(rays, seed=40 + p) for p in range(pairs)])
        pair_id = torch.arange(pairs).repeat_interleave(rays)
    rows = []
    timings = {}
    with monkeypatch.context() as m:
        if way == "plain_keys":
            # the keys by the plain functions, the sweeps still by the kernels
            m.setattr(trace, "runs_cuda", lambda x, impl: False)
        if way == "plain":
            # phase A's fixed-shape bounce, as the kernels' trace runs it,
            # without a graph
            m.setattr(trace, "_image_graph_engages", lambda *a: True)
            m.setattr(trace, "_BounceGraph", _EagerGraph)
        with profiling.call("rv.test", torch.device("cuda"), stats=True, timings=timings):
            stats = profiling.pair_sums()
            images = trace._trace_impl(
                soup, mic, src, dirs, nreflections=reflections,
                impl="plain" if way == "plain" else "auto",
                consume_row=lambda row: rows.append([x.clone() for x in row[:3]]),
                resort=True, stats=stats, pair_id=pair_id)
            sums = stats.clone()
            profiling.stage()
    torch.cuda.synchronize()
    return rows, images, sums, timings["counters"]


@pytest.mark.card
@pytest.mark.parametrize("way, pairs", [("plain_keys", None), ("plain", None),
                                        ("plain_keys", 4)])
def test_trace_with_the_kernels_equals_plain(card, monkeypatch, way, pairs):
    reflections = NUM_IMAGE_SOURCE + 3
    got = _trace(monkeypatch, "fused", pairs)
    want = _trace(monkeypatch, way, pairs)
    assert len(got[0]) == len(want[0]) == reflections
    for a, b in zip(got[0], want[0]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for x, y in zip(got[1], want[1]):
        assert torch.equal(x, y)
    assert torch.equal(got[2], want[2])  # pair tests, live rows, order entries
    # phase A's bounce keys bounce 0's rows too (and keeps their order):
    # every bounce keys its bounce and shadow rows
    keyed = 4096 * (pairs or 1) * 2 * reflections
    counters, plain = got[3], want[3]
    assert counters["sort_keys.fused"] == keyed and "sort_keys.plain" not in counters
    assert counters["launches.ray_keys"] == 2 * reflections
    assert plain["sort_keys.plain"] == keyed and "sort_keys.fused" not in plain
    assert plain["launches.ray_keys"] == 0
    assert counters["bounces.graph"] == reflections
    assert counters["bounces.image_graph"] == NUM_IMAGE_SOURCE - 1
