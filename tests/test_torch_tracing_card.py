"""On the card: the sweep kernel's executed pair tests and live rows
(t_max > 0) by row kind, added by its epilogue into the accumulator
(profiling.pair_sums) in the same launch, equal the plain version's on the
same culled schedule, at one slice and at the schedule's own (and the
per-row counts and the Hit stay the plain version's); and a profiled vault
render's idle gaps, put under the program's stages (portbench/stages.py),
add up to its idle share. This file imports no JAX; on the card run

    python -m pytest --noconftest -m card tests/test_torch_tracing_card.py

Each test skips without a CUDA card."""

import pathlib

import pytest
import torch

from portbench import devtrace, stages
from rayverb_tpu_torch.config.schema import load_config
from rayverb_tpu_torch.ops import intersect, intersect_cuda
from rayverb_tpu_torch.ops.render import render_fused
from rayverb_tpu_torch.scene import load_scene
from rayverb_tpu_torch.utils.directions import random_directions
from rayverb_tpu_torch.utils.profiling import PAIR_SUMS

ASSETS = pathlib.Path(__file__).resolve().parent.parent / "assets"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the sweep kernel runs on the card only")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("decided", [False, True])
@pytest.mark.parametrize("slices", [1, None])
@pytest.mark.parametrize("kinds", [
    ((0, 0, 4000),),
    ((3, 0, 1500), (2, 1500, 3900), (1, 3900, 4000)),
    ((2, 7, 7), (3, 33, 1000), (0, 2000, 3999)),
])
def test_kernel_pair_sums_equal_plain(card, kinds, slices, decided):
    scene = load_scene(str(ASSETS / "test_models" / "vault.obj"),
                       str(ASSETS / "materials" / "vault.json"))
    soup = intersect.soup_from_scene(scene, device=card)
    g = torch.Generator(device=card).manual_seed(11)
    m = 4000
    o = torch.tensor([0.0, 1.75, 0.0], device=card) + 0.5 * torch.randn(
        (m, 3), generator=g, device=card)
    d = torch.nn.functional.normalize(torch.randn((m, 3), generator=g, device=card), dim=-1)
    t_max = torch.where(torch.rand(m, generator=g, device=card) < 0.1, 0.0,
                        torch.rand(m, generator=g, device=card) * 20)
    t_decide = t_max * 0.5 if decided else None
    auto = intersect.sweep_slices(m, soup.block_aabb.shape[0], decided)
    slices = auto if slices is None else slices
    order, counts = intersect_cuda.block_order_cuda(
        o, d, t_max, soup.block_aabb, soup.super_aabb, slices, t_decide=t_decide)
    t_dec = t_decide if decided else torch.zeros_like(t_max)
    acc_plain = torch.zeros(PAIR_SUMS, dtype=torch.int64, device=card)
    pt, pi, p_ex = intersect.closest_hit_plain(
        o, d, soup.packed, soup.block_aabb, t_max, t_dec, order, slices, counts=counts,
        with_stats=True, pair_sums=acc_plain, kinds=kinds)
    acc = torch.zeros(PAIR_SUMS, dtype=torch.int64, device=card)
    hit, k_ex = intersect_cuda.closest_hit_cuda(
        o, d, soup.packed, soup.block_aabb, t_max, t_decide, order, slices, counts=counts,
        with_stats=True, pair_sums=acc, kinds=kinds)
    assert torch.equal(acc, acc_plain) and int(acc[:4].sum()) > 0
    live = torch.zeros(4, dtype=torch.int64, device=card)
    for kind, start, end in kinds:
        live[kind] += (t_max[start:end] > 0).sum()
    assert torch.equal(acc[4:8], live) and int(acc[8:].abs().sum()) == 0
    assert torch.equal(k_ex, p_ex)
    want = intersect.hit_from_raw(pt, pi)
    assert all(torch.equal(a, b) for a, b in zip(hit, want))
    # the accumulator alone (no per-row counts) adds the same sums again
    launches = intersect_cuda.launches
    hit2 = intersect_cuda.closest_hit_cuda(
        o, d, soup.packed, soup.block_aabb, t_max, t_decide, order, slices, counts=counts,
        pair_sums=acc, kinds=kinds)
    assert intersect_cuda.launches == launches + 1
    assert torch.equal(acc, 2 * acc_plain)
    assert all(torch.equal(a, b) for a, b in zip(hit2, want))


@pytest.mark.card
def test_stage_idles_add_up_to_the_idle_share(card):
    """Two warm renders of the vault (vault.json, 50,000 x 128) under
    torch.profiler: the stages' idle seconds plus the unnamed ones
    reproduce the window's idle share within 0.5 points, and both phases
    hold idle time."""
    config = load_config(str(ASSETS / "configs" / "vault.json"))
    scene = load_scene(str(ASSETS / "test_models" / "vault.obj"),
                       str(ASSETS / "materials" / "vault.json"))
    dirs = [random_directions(config.rays, seed=s) for s in (1, 2, 3)]
    render_fused(scene, config, dirs[0], device=card)
    prof = devtrace.profile(lambda: [render_fused(scene, config, d, device=card)
                                     for d in dirs[1:]], 2, card)
    sums = stages.idle_by_stage(prof)
    idle_pct = 100.0 * (1.0 - prof.busy_s / prof.wall_s)
    assert abs(100.0 * sum(sums.values()) / prof.wall_s - idle_pct) <= 0.5
    assert sums["phase_a"] > 0 and sums["phase_b"] >= 0
