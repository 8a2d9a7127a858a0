"""On the card: the order kernel's cull (csrc/closest_hit.cu,
closest_hit_order) and the sweep's walk of the kept entries.
The culled order and its counts equal cull_order of block_order and
block_keep bit for bit, computed on the card and on the CPU, at the
north star's 1,024-block hall and the vault's 32 blocks; the sweep's Hit
and executed-pair counters on that schedule equal closest_hit_plain's on
it and on the whole of each slice's run of block_order; a stats call adds the kept entries and the entries
into the accumulator. This file imports no JAX; on the card run

    python -m pytest --noconftest -m card tests/test_torch_cull_card.py

Each test skips without a CUDA card."""

import functools
import importlib.util
import pathlib

import pytest
import torch

from rayverb_tpu_torch.ops import intersect, intersect_cuda
from rayverb_tpu_torch.scene import load_scene
from rayverb_tpu_torch.utils.directions import morton_sort, random_directions
from rayverb_tpu_torch.utils.profiling import ORDER_ENTRIES, PAIR_SUMS

ROOT = pathlib.Path(__file__).resolve().parent.parent
ASSETS = ROOT / "assets"
RAYS = 6000


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the order and sweep kernels run on the card only")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _soup(name, tmp):
    """The vault (32 blocks), or the benchmark's hall (101,568 triangles,
    1,024 blocks) written by portbench/scenes/gen_hall.py."""
    if name == "vault":
        scene = load_scene(str(ASSETS / "test_models" / "vault.obj"),
                           str(ASSETS / "materials" / "vault.json"))
    else:
        spec = importlib.util.spec_from_file_location(
            "gen_hall", ROOT / "portbench" / "scenes" / "gen_hall.py")
        gen_hall = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(gen_hall)
        path = pathlib.Path(tmp) / "hall.obj"
        gen_hall.generate(str(path), 100_000)
        scene = load_scene(str(path), str(ASSETS / "materials" / "mat.json"))
    return intersect.soup_from_scene(scene, device="cuda")


def _batch(soup, kind, seed):
    """(o, d, t_max, t_decide) of RAYS rows: ``primary`` from one point,
    Morton-ordered directions, t_max +inf; ``bounce`` from points inside
    the scene, a tenth dead, every 7th along an axis; ``shadow`` the
    bounce rows with finite bounds and any-hit thresholds at them, a
    group of them dead."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    lo, hi = soup.bounds[0].cpu(), soup.bounds[1].cpu()
    d = torch.from_numpy(morton_sort(random_directions(RAYS, seed=seed)))
    if kind == "primary":
        o = ((lo + hi) / 2).expand(RAYS, 3).contiguous()
        t_max, t_decide = torch.full((RAYS,), float("inf")), None
    else:
        o = lo + (hi - lo) * (0.1 + 0.8 * torch.rand((RAYS, 3), generator=g))
        o = o[torch.argsort(o[:, 0])].contiguous()
        axes = torch.eye(3)[torch.arange(RAYS) % 3]
        d = torch.where((torch.arange(RAYS) % 7 == 0)[:, None], axes, d).contiguous()
        t_max = torch.where(torch.rand(RAYS, generator=g) < 0.1, 0.0, float("inf"))
        t_decide = None
        if kind == "shadow":
            t_max = torch.where(t_max > 0, 0.5 + 20 * torch.rand(RAYS, generator=g), 0.0)
            t_max[64:96] = 0.0
            t_decide = torch.where(torch.arange(RAYS) % 2 == 0, t_max, 0.0)
    return tuple(None if x is None else x.to(torch.float32).cuda() for x in (o, d, t_max, t_decide))


CASES = [(scene, kind) for scene in ("hall", "vault") for kind in ("primary", "bounce", "shadow")]


@pytest.mark.card
@pytest.mark.parametrize("slices", [1, 8, None])
@pytest.mark.parametrize("scene,kind", CASES)
def test_order_kernel_cull_equals_plain(card, tmp_path_factory, scene, kind, slices):
    soup = _soup(scene, str(tmp_path_factory.getbasetemp()))
    o, d, t_max, t_decide = _batch(soup, kind, 3)
    nb = soup.block_aabb.shape[0]
    if slices is None:
        slices = intersect.sweep_slices(RAYS, nb, t_decide is not None)
    got = intersect_cuda.block_order_cuda(o, d, t_max, soup.block_aabb, soup.super_aabb,
                                          slices, t_decide=t_decide)
    for on in (card, torch.device("cpu")):
        args = [None if x is None else x.to(on) for x in (o, d, t_max, t_decide)]
        aabb = soup.block_aabb.to(on)
        want = intersect.cull_order(intersect.block_order(*args[:3], aabb),
                                    intersect.block_keep(*args, aabb), slices)
        assert torch.equal(got[0].cpu(), want[0].cpu()), on
        assert torch.equal(got[1].cpu(), want[1].cpu()), on
    if (scene, kind) == ("hall", "primary"):
        assert int(got[1].sum()) < got[0].numel() // 4


@pytest.mark.card
@pytest.mark.parametrize("scene,kind", CASES)
def test_sweep_on_the_culled_schedule(card, tmp_path_factory, scene, kind):
    """The kernel on sweep_schedule's culled schedule gives closest_hit_
    plain's Hit and counters on it bit for bit, and closest_hit_plain's on
    the whole of each slice's run of block_order (no cull); a stats call's accumulator holds the kept entries
    and groups x nblocks."""
    soup = _soup(scene, str(tmp_path_factory.getbasetemp()))
    o, d, t_max, t_decide = _batch(soup, kind, 4)
    kinds = ((0, 0, 2000), (3, 2000, RAYS))
    acc = torch.zeros(PAIR_SUMS, dtype=torch.int64, device=card)
    order, slices, counts = intersect.sweep_schedule(o, d, t_max, t_decide, soup, acc)
    args = (o, d, soup.packed, soup.block_aabb, t_max, t_decide)
    hit, ex = intersect_cuda.closest_hit_cuda(*args, order, slices, counts=counts,
                                              with_stats=True, pair_sums=acc, kinds=kinds)
    t_max_p, t_dec_p = intersect._bounds(RAYS, t_max, t_decide, card)
    acc_plain = torch.zeros(PAIR_SUMS, dtype=torch.int64, device=card)
    pt, pi, p_ex = intersect.closest_hit_plain(
        o, d, soup.packed, soup.block_aabb, t_max_p, t_dec_p, order, slices, counts=counts,
        with_stats=True, pair_sums=acc_plain, kinds=kinds)
    assert all(torch.equal(a, b) for a, b in zip(hit, intersect.hit_from_raw(pt, pi)))
    assert torch.equal(ex, p_ex) and torch.equal(acc[:ORDER_ENTRIES], acc_plain[:ORDER_ENTRIES])
    full = intersect.block_order(o, d, t_max, soup.block_aabb)
    acc_full = torch.zeros(PAIR_SUMS, dtype=torch.int64, device=card)
    ut, ui, uncut_ex = intersect.closest_hit_plain(
        o, d, soup.packed, soup.block_aabb, t_max_p, t_dec_p, full, slices,
        with_stats=True, pair_sums=acc_full, kinds=kinds)
    assert all(torch.equal(a, b) for a, b in zip(hit, intersect.hit_from_raw(ut, ui)))
    assert torch.equal(ex, uncut_ex)
    assert torch.equal(acc[:ORDER_ENTRIES], acc_full[:ORDER_ENTRIES])
    nb = soup.block_aabb.shape[0]
    assert int(acc[ORDER_ENTRIES]) == int(counts.sum())
    assert int(acc[ORDER_ENTRIES + 1]) == order.shape[0] * nb
    assert bool(hit.hit.any()) and int(ex.sum()) > 0
