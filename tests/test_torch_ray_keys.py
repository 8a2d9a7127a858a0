"""The trace's per-bounce sort keys on the CPU (ops/trace.py ``_bounce_key``,
``_shadow_key``; the CUDA kernels of csrc/ray_keys.cu run on the card only,
tests/test_torch_ray_keys_card.py).

The keys are uint32 values; the trace sorts them as int32 with the top bit
flipped (``_signed32``), which the kernels write, and a stable sort of
those gives the uint32 values' permutation. The multi-pair shadow key stays
the int64 (pair, key). Here: that order, on keys with the top bit set, ties
and dead rows; the dispatch by ``impl`` and its counters; and a numpy twin
of the kernels' uint32 arithmetic held to the plain functions bit for bit
on the edge cases of the card test."""

import pathlib

import numpy as np
import pytest
import torch

from rayverb_tpu_torch.ops import intersect, ray_keys_cuda, trace
from rayverb_tpu_torch.scene import load_scene
from rayverb_tpu_torch.utils import profiling
from rayverb_tpu_torch.utils.directions import random_directions

U32 = 0xFFFFFFFF
ASSETS = pathlib.Path(__file__).resolve().parent.parent / "assets"
# a hair off the box's symmetry planes (tests/test_torch_bounce_graph.py)
MIC = [0.013, 2.017, 0.021]
SOURCE = [0.031, 1.989, 2.007]


def _unit(rng, n):
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))


def _stable(key):
    return torch.argsort(key, stable=True)


def _edge_dirs():
    """Axis directions, +-0 components, and the cube's corners."""
    rows = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
            [0.0, -0.0, 1.0], [-0.0, -0.0, -1.0], [0.6, -0.0, 0.8]]
    rows += [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    d = torch.tensor(rows, dtype=torch.float32)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def _bounce_inputs(rng, n):
    """Positions inside, on and outside the bounds [lo, lo + 1 / inv_span],
    and directions with the edge cases first."""
    lo = torch.tensor([-2.0, -1.0, 0.5])
    inv_span = 1.0 / torch.tensor([12.0, 7.5, 9.0])
    hi = lo + 1.0 / inv_span
    pos = torch.from_numpy(rng.uniform(-4.0, 14.0, (n, 3)).astype(np.float32))
    pos[0], pos[1], pos[2] = lo, hi, (lo + hi) / 2
    pos[3] = torch.tensor([0.0, -0.0, 0.0])
    d = _unit(rng, n)
    edge = _edge_dirs()
    d[: edge.shape[0]] = edge
    return pos, d, lo, inv_span


# ---------------------------------------------------------------------------
# the int32 order
# ---------------------------------------------------------------------------

def test_signed32_keeps_the_uint32_order():
    rng = np.random.default_rng(0)
    edges = [0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, U32 - 1, U32, U32, 0x80000000, 0]
    key = torch.from_numpy(np.concatenate([
        np.array(edges, np.int64),
        rng.integers(0, 1 << 32, 5000, dtype=np.int64),
        rng.integers(0x80000000 - 3, 0x80000000 + 3, 200, dtype=np.int64),  # ties
    ]))
    flipped = trace._signed32(key)
    assert flipped.dtype == torch.int32
    np.testing.assert_array_equal(flipped.numpy().view(np.uint32) ^ np.uint32(0x80000000),
                                  key.numpy().astype(np.uint32))
    assert torch.equal(_stable(flipped), _stable(key))


@pytest.mark.parametrize("n", [300, 5000])
def test_plain_bounce_key_sorts_as_the_mix6_key(n):
    pos, d, lo, inv_span = _bounce_inputs(np.random.default_rng(n), n)
    wide = trace._ray_sort_key(pos, d, lo, inv_span)
    key = trace._bounce_key(pos, d, lo, inv_span, "plain")
    assert key.dtype == torch.int32
    assert int(wide.max()) >= 1 << 31 and int(wide.min()) < 1 << 31  # both halves
    assert torch.equal(key.long() + 0x80000000, wide)
    assert torch.equal(_stable(key), _stable(wide))


@pytest.mark.parametrize("pairs", [None, 4])
def test_plain_shadow_key(pairs):
    """Single pair: int32, the dead rows (0xFFFFFFFF) last, the permutation
    of the uint32 keys. Multi-pair: the int64 (pair, key) as before."""
    rng = np.random.default_rng(7)
    n = 2000
    d = _unit(rng, n)
    d[:17] = _edge_dirs()
    d[17:40] = d[40:63]  # ties
    alive = torch.from_numpy(rng.random(n) < 0.7)
    wide = torch.where(alive, trace._dir_morton(d), U32)
    pair = None if pairs is None else torch.from_numpy(rng.integers(0, pairs, n))
    key = trace._shadow_key(d, alive, pair, "plain")
    if pair is None:
        assert key.dtype == torch.int32
        assert torch.equal(key.long() + 0x80000000, wide)
        perm = _stable(key)
        assert torch.equal(perm, _stable(wide))
        dead = int((~alive).sum())
        assert not alive[perm[-dead:]].any() and alive[perm[:-dead]].all()
    else:
        assert key.dtype == torch.int64
        assert torch.equal(key, (torch.where(alive, pair, 0x7FFFFFFF) << 32) | wide)


# ---------------------------------------------------------------------------
# dispatch and counters
# ---------------------------------------------------------------------------

def _counted(fn):
    timings = {}
    with profiling.call("rv.test", torch.device("cpu"), stats=True, timings=timings):
        out = fn()
    return out, timings["counters"]


@pytest.mark.parametrize("impl", ["plain", "auto"])
def test_cpu_and_plain_run_the_plain_functions(monkeypatch, impl):
    calls = []
    for name in ("_ray_sort_key", "_dir_morton"):
        real = getattr(trace, name)
        monkeypatch.setattr(trace, name, lambda *a, real=real, name=name:
                            calls.append(name) or real(*a))

    def refuse(*a, **k):
        raise AssertionError("the kernel ran")

    monkeypatch.setattr(ray_keys_cuda, "bounce_key_cuda", refuse)
    monkeypatch.setattr(ray_keys_cuda, "shadow_key_cuda", refuse)
    pos, d, lo, inv_span = _bounce_inputs(np.random.default_rng(1), 64)
    alive = torch.ones(64, dtype=torch.bool)
    _, counters = _counted(lambda: (trace._bounce_key(pos, d, lo, inv_span, impl),
                                    trace._shadow_key(d, alive, None, impl)))
    assert calls == ["_ray_sort_key", "_dir_morton", "_dir_morton"]
    assert counters["sort_keys.plain"] == 128 and "sort_keys.fused" not in counters


@pytest.mark.parametrize("impl, want", [("auto", False), ("plain", False), ("cuda", True)])
def test_dispatch_rule_on_cpu_tensors(impl, want):
    # one rule for closest_hit and the keys: 'auto' follows the tensor
    assert trace.runs_cuda is intersect.runs_cuda
    assert intersect.runs_cuda(torch.zeros(3), impl) is want


def test_cuda_impl_refuses_cpu_tensors():
    pos, d, lo, inv_span = _bounce_inputs(np.random.default_rng(2), 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        trace._bounce_key(pos, d, lo, inv_span, "cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        trace._shadow_key(d, torch.ones(32, dtype=torch.bool), None, "cuda")


@pytest.mark.parametrize("resort, pairs", [(True, None), (False, None), (True, 3)])
def test_trace_counts_its_keyed_rows(resort, pairs):
    """Every bounce keys its shadow rows; with resort every bounce after
    the first keys its bounce rows too; on the CPU all by the plain path."""
    scene = load_scene(str(ASSETS / "test_models" / "large_square.obj"),
                       str(ASSETS / "materials" / "mat.json"))
    soup = intersect.soup_from_scene(scene, device="cpu")
    nrays, refl = 64, 4
    kw = {}
    if pairs is None:
        mic, src, dirs = MIC, SOURCE, random_directions(nrays, seed=3)
    else:
        mic = np.float32([MIC] * pairs) + np.float32([[0.1 * p, 0, 0] for p in range(pairs)])
        src = np.float32([SOURCE] * pairs)
        dirs = np.concatenate([random_directions(nrays, seed=p) for p in range(pairs)])
        kw = {"pair_id": torch.arange(pairs).repeat_interleave(nrays),
              "consume_row": lambda row: None}
    rows = nrays * (pairs or 1)
    _, counters = _counted(lambda: trace._trace_impl(
        soup, mic, src, dirs, nreflections=refl, resort=resort, **kw))
    assert counters["sort_keys.plain"] == rows * (2 * refl - 1 if resort else refl)
    assert "sort_keys.fused" not in counters
    assert counters["launches.ray_keys"] == 0


# ---------------------------------------------------------------------------
# the kernels' arithmetic, as a numpy twin
# ---------------------------------------------------------------------------

def _spread(x, steps):
    x = x.astype(np.uint32)
    for shift, mask in steps:
        x = (x | (x << np.uint32(shift))) & np.uint32(mask)
    return x


def _spread9(x):
    return _spread(x & np.uint32(0x1FF), ((16, 0x030000FF), (8, 0x0300F00F),
                                          (4, 0x030C30C3), (2, 0x09249249)))


def _spread16(x):
    return _spread(x & np.uint32(0xFFFF), ((8, 0x00FF00FF), (4, 0x0F0F0F0F),
                                           (2, 0x33333333), (1, 0x55555555)))


def _quant9(x):
    return np.minimum(np.maximum(x, np.float32(0)), np.float32(511)).astype(np.uint32)


def _morton(q):
    return _spread9(q[:, 0]) | (_spread9(q[:, 1]) << np.uint32(1)) | (
        _spread9(q[:, 2]) << np.uint32(2))


def _twin_dir_morton(d):
    return _morton(_quant9((d * np.float32(0.5) + np.float32(0.5)) * np.float32(511)))


def _twin_signed(key):
    return (key ^ np.uint32(0x80000000)).view(np.int32)


def twin_bounce_key(pos, d, lo, inv_span):
    """rv_bounce_key's arithmetic in numpy float32 and uint32."""
    m = _morton(_quant9((pos - lo) * inv_span * np.float32(511)))
    dm = _twin_dir_morton(d)
    return _twin_signed((_spread16(m >> np.uint32(11)) << np.uint32(1))
                        | _spread16(dm >> np.uint32(11)))


def twin_shadow_key(d, alive, pair=None):
    """rv_shadow_key's arithmetic in numpy."""
    key = np.where(alive, _twin_dir_morton(d), np.uint32(U32)).astype(np.uint32)
    if pair is None:
        return _twin_signed(key)
    major = np.where(alive, pair, 0x7FFFFFFF).astype(np.uint64)
    return ((major << np.uint64(32)) | key.astype(np.uint64)).view(np.int64)


def test_twin_of_the_kernels_equals_the_plain_keys():
    rng = np.random.default_rng(11)
    n = 4096
    pos, d, lo, inv_span = _bounce_inputs(rng, n)
    # positions landing exactly on 0 and on 511 of the grid
    pos[4] = lo
    lo1, inv1 = torch.zeros(3), torch.ones(3)
    got = twin_bounce_key(*(x.numpy() for x in (pos, d, lo, inv_span)))
    np.testing.assert_array_equal(got, trace._bounce_key(pos, d, lo, inv_span, "plain").numpy())
    unit = torch.tensor([[1.0, 0.0, -0.0], [0.0, 1.0, 1.0], [1.0, 1.0, 1.0], [2.0, -1.0, 0.5]])
    np.testing.assert_array_equal(
        twin_bounce_key(unit.numpy(), d[:4].numpy(), lo1.numpy(), inv1.numpy()),
        trace._bounce_key(unit, d[:4], lo1, inv1, "plain").numpy())
    alive = torch.from_numpy(rng.random(n) < 0.8)
    np.testing.assert_array_equal(twin_shadow_key(d.numpy(), alive.numpy()),
                                  trace._shadow_key(d, alive, None, "plain").numpy())
    pair = torch.from_numpy(rng.integers(0, 64, n))
    np.testing.assert_array_equal(twin_shadow_key(d.numpy(), alive.numpy(), pair.numpy()),
                                  trace._shadow_key(d, alive, pair, "plain").numpy())
