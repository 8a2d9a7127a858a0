"""The port's batched IR datagen (rayverb_tpu_torch/parallel/datagen.py and
the multi-pair trace of ops/trace.py) against the JAX package's, on the
CPU, at a small size: large_square, 3 pairs (the sources and mics of
tests/test_datagen.py, moved a hair off the box's symmetry plane x = 0),
96 rays and 8 reflections, 8 kHz. On the plane, two of pair 0's image
chains reflect exactly on a diagonal that two coplanar triangles share,
where float32 rounding decides admission; the tests at the unmoved inputs
pin those records, hold the port's verdict to a float64 witness, and show
that the port computes those chains as the JAX helpers do eagerly, bit for
bit, while the JAX trace's jit-fused arithmetic rejects them.

Tolerances, as the single-pair tests hold them:
  - binning on the same rows: 1e-6 of peak (the sums' order differs)
  - trace records: tests/test_torch_trace.py's atol per field
  - whole batches: -60 dB of each pair's peak, forgiving single-bin
    displacement (tests/test_torch_render.py), contents equal; HRTF batches
    on shared trace records, because an ear's ITD shift moves an arrival
    across a bin edge when the two packages' times differ by an ulp
  - against the port's own render_fused per pair: 1e-5 of peak, the JAX
    package's own test_batched_matches_sequential tolerance
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayverb_tpu import load_scene
from rayverb_tpu.config.schema import parse_config as jax_parse_config
from rayverb_tpu.ops import intersect as jax_isect
from rayverb_tpu.ops import render as jax_render
from rayverb_tpu.ops import trace as jax_trace
from rayverb_tpu.parallel import datagen as jax_datagen
from rayverb_tpu.utils.directions import random_directions
from rayverb_tpu_torch.config.schema import parse_config as port_parse_config
from rayverb_tpu_torch.ops import intersect as port_isect
from rayverb_tpu_torch.ops import render as port_render
from rayverb_tpu_torch.ops import trace as port_trace
from rayverb_tpu_torch.ops.filters import KERNEL_LENGTH
from rayverb_tpu_torch.parallel import datagen as port_datagen

torch.set_num_threads(1)

DB60 = 1e-3
NRAYS = 96
NREFL = 8
SOURCES = (np.float32([[0, 2, 2], [1, 3, 0], [-2, 5, 1]])
           + np.float32([0.031, -0.011, 0.007]))
MICS = (np.float32([[0, 2, 0], [0, 4, 2], [2, 6, -1]])
        + np.float32([0.013, 0.017, 0.021]))
SPEAKERS = {"speakers": [{"direction": [0, 0, 1], "shape": 0.5},
                         {"direction": [1, 0, 0], "shape": 0.0}]}
HRTF = {"hrtf": {"facing": [0, 0, 1], "up": [0, 1, 0]}}
TRACE_ATOL = {
    "diffuse_volume": 1e-6, "diffuse_position": 1e-4, "diffuse_time": 1e-6,
    "image_volume": 1e-6, "image_position": 1e-3, "image_time": 1e-6,
}


def _doc(**overrides):
    doc = {
        "rays": NRAYS, "reflections": NREFL, "sample_rate": 8000, "bit_depth": 16,
        "source_position": [0, 0, 0], "mic_position": [0, 0, 0],  # per pair
        "attenuation_model": SPEAKERS, "normalize": False,
        "trim_tail": False, "trim_predelay": False,
    }
    doc.update(overrides)
    return json.dumps(doc)


@pytest.fixture(scope="module")
def box(assets_dir):
    return load_scene(str(assets_dir / "test_models" / "large_square.obj"),
                      str(assets_dir / "materials" / "mat.json"))


@pytest.fixture(scope="module")
def dirs():
    return np.stack([random_directions(NRAYS, seed=i) for i in range(len(SOURCES))])


@pytest.fixture(scope="module")
def jax_batches():
    """JAX render_irs_batched results by case, computed once per module."""
    return {}


def _jax_batch(cache, box, dirs, text, monkeypatch=None, method=None):
    key = (text, method)
    if key not in cache:
        if method is not None:
            monkeypatch.setenv("RAYVERB_FINALIZE_FILTER", method)
        irs, contents = jax_datagen.render_irs_batched(
            box, jax_parse_config(text), SOURCES, MICS, dirs)
        cache[key] = (np.asarray(irs, np.float64), np.asarray(contents))
    return cache[key]


def _assert_within_60db(got, want):
    """Per pair: max error under 1e-3 of the pair's peak, forgiving
    single-sample displacement."""
    assert got.shape == want.shape
    for i in range(want.shape[0]):
        peak = np.abs(want[i]).max()
        assert peak > 0
        errs = [np.abs(got[i] - np.roll(want[i], s, axis=-1)) for s in (0, 1, -1)]
        err = np.minimum(np.minimum(errs[0], errs[1]), errs[2]).max() / peak
        assert err < DB60, f"pair {i}: max error {err:.2e} exceeds -60 dB"


# ---------------------------------------------------------------------------
# the multi-pair binning and hashes on the same rows
# ---------------------------------------------------------------------------

def _rows(seed, m=600, nbatch=3, length=512):
    """Diffuse-like rows of 3 pairs: a third of them silent, times inside
    and a few outside [0, length) bins at 8 kHz."""
    rng = np.random.default_rng(seed)
    vol = rng.uniform(-1, 1, (m, 8)).astype(np.float32)
    vol[rng.random(m) < 0.3] = 0.0
    pos = rng.uniform(-4, 4, (m, 3)).astype(np.float32)
    tim = rng.uniform(0.0, length * 1.05 / 8000.0, m).astype(np.float32)
    pair = rng.integers(0, nbatch, m).astype(np.int32)
    return vol, pos, tim, pair


def _specs(model):
    jcfg = jax_parse_config(_doc(attenuation_model=model))
    pcfg = port_parse_config(_doc(attenuation_model=model))
    return (jax_render.make_atten_spec(jcfg.attenuation_model),
            port_render.make_atten_spec(pcfg.attenuation_model, "cpu"))


@pytest.mark.parametrize("model", ["speakers", "hrtf"])
def test_bin_rows_sorted_multi_matches_jax_and_scatter(model):
    """_bin_rows_sorted_multi against JAX's on the same rows, and against
    the port's own scatter binning (_attenuate_and_bin_multi): banks within
    1e-6 of peak, per-pair time stats equal."""
    jspec, pspec = _specs(SPEAKERS if model == "speakers" else HRTF)
    vol, pos, tim, pair = _rows(1)
    nb, length, sr = 3, 512, 8000.0
    mic_rows = MICS[pair]
    t0 = (jnp.full((nb,), jnp.inf, jnp.float32), jnp.zeros((nb,), jnp.float32))
    want, wmin, wmax = jax_datagen._bin_rows_sorted_multi(
        jnp.asarray(mic_rows), jnp.asarray(pair), jnp.asarray(vol), jnp.asarray(pos),
        jnp.asarray(tim), jspec, length, jnp.float32(sr), nb, tstats=t0)
    want = np.asarray(want)
    args = (torch.from_numpy(mic_rows), torch.from_numpy(pair).long(), torch.from_numpy(vol),
            torch.from_numpy(pos), torch.from_numpy(tim), pspec, length, sr, nb)
    got, gmin, gmax = port_datagen._bin_rows_sorted_multi(*args)
    scat, smin, smax = port_datagen._attenuate_and_bin_multi(*args)
    peak = np.abs(want).max()
    assert got.shape == (nb, pspec.nchannels, 8, length) and peak > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * peak)
    np.testing.assert_allclose(scat.numpy(), want, rtol=0, atol=1e-6 * peak)
    for g, s, w in ((gmin, smin, wmin), (gmax, smax, wmax)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(s.numpy(), np.asarray(w))


def test_bin_rows_sorted_multi_adds_into_init_hist():
    _, pspec = _specs(SPEAKERS)
    vol, pos, tim, pair = _rows(2)
    args = (torch.from_numpy(MICS[pair]), torch.from_numpy(pair).long(), torch.from_numpy(vol),
            torch.from_numpy(pos), torch.from_numpy(tim), pspec, 512, 8000.0, 3)
    base, _, _ = port_datagen._bin_rows_sorted_multi(*args)
    twice, _, _ = port_datagen._bin_rows_sorted_multi(*args, init_hist=base)
    assert torch.equal(twice, base + base)


def test_pair_hashes_match_jax():
    """The pair-seeded chain hashes, bit for bit, with pairs large enough
    that pair * 0x9E3779B9 overflows 32 bits."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 5000, (400, 10)).astype(np.int32)
    idx[:, 4:] *= rng.random((400, 6)) < 0.5
    pair = rng.integers(0, 1 << 20, 400).astype(np.int32)
    h1, h2 = jax_render.chain_hashes(jnp.asarray(idx))
    pair_u = jnp.asarray(pair).astype(jnp.uint32)[:, None]
    w1 = np.asarray(jax_render._mix32(h1 ^ pair_u)).astype(np.int64)
    w2 = np.asarray(jax_render._mix32(h2 + pair_u * np.uint32(0x9E3779B9))).astype(np.int64)
    g1, g2 = port_datagen.pair_hashes(torch.from_numpy(idx).long(), torch.from_numpy(pair))
    np.testing.assert_array_equal(g1.numpy(), w1)
    np.testing.assert_array_equal(g2.numpy(), w2)


# ---------------------------------------------------------------------------
# the multi-pair trace
# ---------------------------------------------------------------------------

def _flat(dirs):
    b, n = dirs.shape[:2]
    return dirs.reshape(b * n, 3), np.repeat(np.arange(b, dtype=np.int32), n)


def _jax_multi_trace(jsoup, dirs, resort):
    """The JAX multi-pair trace (pair_id mode, XLA sweep): its diffuse rows
    collected into (R, B*N, .) buffers, and the image slots."""
    flat, pair = _flat(dirs)

    @jax.jit
    def run(soup, mics, sources, d, p):
        aux, images, _ = jax_trace._trace_impl(
            soup, mics, sources, d, nreflections=NREFL, impl="xla",
            consume_row=lambda bufs, row: jax_render._collect_row(bufs, row[:3]),
            aux0=jax_render._row_buffers(NREFL, d.shape[0]), resort=resort, pair_id=p)
        return aux[:3], images

    rows, images = run(jsoup, MICS, SOURCES, flat, pair)
    return [np.asarray(x) for x in rows], [np.asarray(x) for x in images]


@pytest.mark.parametrize("resort", [False, True])
def test_multi_pair_trace_matches_jax(box, dirs, resort):
    """Every diffuse row and image record of the multi-pair trace against
    the JAX _trace_impl(pair_id=...), and the consumed rows' mic and pair
    columns."""
    (wv, wp, wt), wimg = _jax_multi_trace(jax_isect.soup_from_scene(box), dirs, resort)
    flat, pair = _flat(dirs)
    rows = []
    images = port_trace._trace_impl(
        port_isect.soup_from_scene(box, device="cpu"), MICS, SOURCES, flat,
        nreflections=NREFL, impl="plain", consume_row=rows.append, resort=resort,
        pair_id=torch.from_numpy(pair))
    assert len(rows) == NREFL
    for b, (vol, pos, tim, mic_rows, pair_rows) in enumerate(rows):
        np.testing.assert_allclose(vol.numpy(), wv[b], rtol=0, atol=TRACE_ATOL["diffuse_volume"])
        np.testing.assert_allclose(pos.numpy(), wp[b], rtol=0, atol=TRACE_ATOL["diffuse_position"])
        np.testing.assert_allclose(tim.numpy(), wt[b], rtol=0, atol=TRACE_ATOL["diffuse_time"])
        np.testing.assert_array_equal(mic_rows.numpy(), MICS[pair])
        np.testing.assert_array_equal(pair_rows.numpy(), pair)
    for name, g, w in zip(("image_volume", "image_position", "image_time"), images, wimg):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TRACE_ATOL[name], err_msg=name)
    np.testing.assert_array_equal(images[3].numpy(), wimg[3])
    assert (images[3][:, 1:] != 0).any(), "no image source was found"
    assert sum(float(r[0].abs().sum()) for r in rows) > 0


def test_multi_pair_trace_needs_the_consume_path(box, dirs):
    flat, pair = _flat(dirs)
    with pytest.raises(ValueError, match="consume_row"):
        port_trace._trace_impl(port_isect.soup_from_scene(box, device="cpu"), MICS, SOURCES,
                               flat, nreflections=2, pair_id=torch.from_numpy(pair))


def test_shadow_rows_sort_pair_major():
    """Alive rows sort by (pair, direction key), dead rows last, as JAX
    lexsort((key, dead))."""
    rng = np.random.default_rng(4)
    n = 300
    mic = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    inter = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    alive = rng.random(n) < 0.7
    mag = np.linalg.norm(inter - mic, axis=-1).astype(np.float32)
    pair = rng.integers(0, 4, n).astype(np.int32)
    want = jax_trace._shadow_rows(jnp.asarray(mic), jnp.asarray(inter), jnp.asarray(alive),
                                  jnp.asarray(mag), pair=jnp.asarray(pair))
    got = port_trace._shadow_rows(torch.from_numpy(mic), torch.from_numpy(inter),
                                  torch.from_numpy(alive), torch.from_numpy(mag),
                                  torch.from_numpy(pair).long())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# whole batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bin_mode", ["sorted", "scatter"])
@pytest.mark.parametrize("trim_predelay", [False, True])
def test_batched_speakers_match_jax(box, dirs, jax_batches, bin_mode, trim_predelay):
    """Speakers, each package on its own trace: -60 dB of each pair's
    peak, contents equal."""
    text = _doc(trim_predelay=trim_predelay)
    want, wc = _jax_batch(jax_batches, box, dirs, text)
    got, gc = port_datagen.render_irs_batched(box, port_parse_config(text), SOURCES, MICS,
                                              dirs, device="cpu", bin_mode=bin_mode)
    assert got.dtype == torch.float32 and got.shape == (3, 2, want.shape[-1])
    _assert_within_60db(got.numpy().astype(np.float64), want)
    np.testing.assert_array_equal(gc.numpy(), wc)


@pytest.mark.parametrize("method", ["scan", "fft"])
def test_batched_finalize_methods_match_jax(box, dirs, jax_batches, monkeypatch, method):
    """The Linkwitz-Riley bank, normalised per pair, through the scan (one
    scan per pass over every pair's series, each with its own content
    length) and the fft finalize."""
    text = _doc(filter="linkwitz_riley", normalize=True, trim_predelay=True)
    want, wc = _jax_batch(jax_batches, box, dirs, text, monkeypatch, method)
    monkeypatch.setenv("RAYVERB_FINALIZE_FILTER", method)
    got, gc = port_datagen.render_irs_batched(box, port_parse_config(text), SOURCES, MICS,
                                              dirs, device="cpu")
    _assert_within_60db(got.numpy().astype(np.float64), want)
    np.testing.assert_array_equal(gc.numpy(), wc)
    np.testing.assert_allclose(np.abs(got.numpy()).max(axis=(1, 2)), 1.0, rtol=1e-6)


def test_batched_scan_finalize_is_one_launch_per_pass(box, dirs, monkeypatch):
    """With the scan finalize each pass is one biquad_onepass call over
    every pair's series, with per-pair content lengths."""
    from rayverb_tpu_torch.ops import filters

    calls = []
    real = filters.biquad_onepass

    def spy(data, coeffs, *, reverse=False, content_len=None):
        calls.append((tuple(data.shape), content_len.reshape(-1).tolist()))
        return real(data, coeffs, reverse=reverse, content_len=content_len)

    monkeypatch.setattr(filters, "biquad_onepass", spy)
    monkeypatch.setenv("RAYVERB_FINALIZE_FILTER", "scan")
    text = _doc(filter="linkwitz_riley")
    _, contents = port_datagen.render_irs_batched(box, port_parse_config(text), SOURCES, MICS,
                                                  dirs, device="cpu")
    assert len(calls) == 4
    assert all(shape[:3] == (3, 2, 8) and lens == contents.tolist() for shape, lens in calls)


def _feed_jax_multi_trace(monkeypatch, box):
    """Replace the port datagen's trace by the JAX multi-pair trace of the
    same rows, fed through the port's consume protocol, so that both
    packages bin the same records."""
    jsoup = jax_isect.soup_from_scene(box)

    def trace(_soup, mics, sources, directions, *, nreflections, impl, consume_row,
              resort, stats, pair_id):
        flat = directions.numpy()
        pair = pair_id.numpy().astype(np.int32)
        nb = len(mics)
        rows, images = _jax_multi_trace(jsoup, flat.reshape(nb, -1, 3), resort)
        np.testing.assert_array_equal(pair, _flat(flat.reshape(nb, -1, 3))[1])
        t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
        mic_rows = mics[pair_id]
        for b in range(nreflections):
            consume_row((t(rows[0][b]), t(rows[1][b]), t(rows[2][b]), mic_rows, pair_id))
        return t(images[0]), t(images[1]), t(images[2]), t(images[3]).long()

    monkeypatch.setattr(port_datagen, "_trace_impl", trace)


@pytest.mark.parametrize("trim_predelay", [False, True])
def test_batched_hrtf_matches_jax_on_shared_trace(box, dirs, jax_batches, monkeypatch,
                                                  trim_predelay):
    """Stereo HRTF, the port binning the JAX trace's records: -60 dB,
    contents equal; with trim_predelay the pairs' predelays differ, so
    each pair's bank shifts by its own bins, its head summed into bin 0."""
    text = _doc(attenuation_model=HRTF, trim_predelay=trim_predelay)
    want, wc = _jax_batch(jax_batches, box, dirs, text)
    _feed_jax_multi_trace(monkeypatch, box)
    got, gc = port_datagen.render_irs_batched(box, port_parse_config(text), SOURCES, MICS,
                                              dirs, device="cpu")
    _assert_within_60db(got.numpy().astype(np.float64), want)
    np.testing.assert_array_equal(gc.numpy(), wc)


@pytest.mark.parametrize("mode", ["all", "image_only", "diffuse_only"])
def test_batched_matches_port_render_fused(box, dirs, mode):
    """Each pair of the batch against the port's own single-pair render of
    the same pair and rays: 1e-5 of peak over the whole IR, silence beyond
    the content length, equal contents; the output mode is honoured as
    render_fused honours it (the JAX batch ignores it)."""
    text = _doc(trim_predelay=True, output_mode=mode)
    irs, contents = port_datagen.render_irs_batched(box, port_parse_config(text), SOURCES,
                                                    MICS, dirs, device="cpu")
    for i in range(len(SOURCES)):
        cfg = port_parse_config(_doc(trim_predelay=True, output_mode=mode,
                                     source_position=SOURCES[i].tolist(),
                                     mic_position=MICS[i].tolist()))
        single, info = port_render.render_fused(box, cfg, dirs[i], device="cpu")
        n = single.shape[-1]
        peak = np.abs(single).max()
        assert peak > 0 and int(contents[i]) == info["content_length"] == n
        np.testing.assert_allclose(irs[i, :, :n].numpy(), single, rtol=0, atol=1e-5 * peak)
        assert float(irs[i, :, n:].abs().max()) < 1e-6 * peak


def test_image_dedup_keeps_one_row_per_chain(box, dirs):
    """The dedup keeps, per pair, exactly as many image rows as that pair
    has distinct admitted chains (JAX keeps the first row of each equal
    (h1, h2) run; which duplicate wins changes nothing)."""
    from rayverb_tpu_torch.ops.render import _dedup_rows

    text = _doc()
    cfg = port_parse_config(text)
    soup = port_isect.soup_from_scene(box, device="cpu")
    spec = port_render.make_atten_spec(cfg.attenuation_model, "cpu")
    flat, pair = _flat(dirs)
    pair_id = torch.from_numpy(pair).long()
    _, imgs, _, _ = port_datagen._batched_trace_bin(
        soup, torch.from_numpy(MICS), torch.from_numpy(SOURCES), torch.from_numpy(flat),
        pair_id, spec, nbatch=3, nreflections=NREFL, length=4096, sample_rate=8000.0,
        impl="plain", bin_mode="sorted", resort=False, include_diffuse=True)
    chosen = _dedup_rows(imgs, remove_direct=False)
    chains = {}
    h1, h2 = imgs.h1.numpy(), imgs.h2.numpy()
    for r, s in zip(*np.nonzero(imgs.valid.numpy())):
        chains.setdefault(int(pair[r]), set()).add((int(h1[r, s]), int(h2[r, s])))
    kept = {}
    for row in chosen.tolist():
        p = int(pair[row // 10])
        kept[p] = kept.get(p, 0) + 1
    assert kept == {p: len(c) for p, c in chains.items()}
    assert all(kept[p] > 1 for p in range(3))


def test_microbatch_one_matches_one_pass(box, dirs):
    """Pairs are independent: one pair per pass gives the one-pass batch
    bit for bit (HRTF, trim_predelay on, sorted binning)."""
    cfg = port_parse_config(_doc(attenuation_model=HRTF, trim_predelay=True,
                                 filter="linkwitz_riley", normalize=True))
    one, c1 = port_datagen.render_irs_batched(box, cfg, SOURCES, MICS, dirs, device="cpu")
    each, c2, info = port_datagen.render_irs_batched(box, cfg, SOURCES, MICS, dirs,
                                                     device="cpu", microbatch=1, stats=True)
    assert info["passes"] == 3 and info["pairs_per_pass"] == 1
    assert info["sweeps"] == 3 * port_trace.sweep_count(NREFL)
    assert torch.equal(one, each) and torch.equal(c1, c2)


@pytest.mark.parametrize("filt", ["onepass", "sinc"])
def test_trim_batch_matches_single_pair(box, dirs, filt):
    """trim_batch with both trims on reproduces each pair's single-pair
    render. With the windowed-sinc bank the content length grows by
    KERNEL_LENGTH - 1 first, as render_fused grows it; the JAX trim_batch
    does not (its fault, rayverb_tpu/parallel/datagen.py:561, ADVICE.md:
    it cuts the convolution tail), which the last assertion shows."""
    text = _doc(filter=filt, trim_predelay=True, trim_tail=True)
    cfg = port_parse_config(text)
    irs, contents = port_datagen.render_irs_batched(box, cfg, SOURCES, MICS, dirs,
                                                    device="cpu")
    trimmed = port_datagen.trim_batch(irs, contents, cfg)
    jax_trimmed = jax_datagen.trim_batch(irs.numpy(), contents.numpy(), jax_parse_config(text))
    for i in range(len(SOURCES)):
        single, info = port_render.render_fused(
            box, port_parse_config(_doc(filter=filt, trim_predelay=True, trim_tail=True,
                                        source_position=SOURCES[i].tolist(),
                                        mic_position=MICS[i].tolist())),
            dirs[i], device="cpu")
        assert trimmed[i].shape == single.shape, f"pair {i}"
        np.testing.assert_allclose(trimmed[i], single, rtol=0,
                                   atol=1e-5 * np.abs(single).max())
        if filt == "sinc":
            assert info["content_length"] == int(contents[i]) + KERNEL_LENGTH - 1
            assert jax_trimmed[i].shape[-1] < single.shape[-1]
        else:
            assert jax_trimmed[i].shape == single.shape


def test_trim_batch_without_trim_tail_cuts_at_content(box, dirs):
    cfg = port_parse_config(_doc())
    irs, contents = port_datagen.render_irs_batched(box, cfg, SOURCES[:1], MICS[:1], dirs[:1],
                                                    device="cpu")
    out = port_datagen.trim_batch(irs, contents, cfg)
    assert len(out) == 1 and out[0].shape == (2, int(contents[0]))


def test_stats_count_executed_pairs_by_kind(box, dirs):
    cfg = port_parse_config(_doc())
    _, _, info = port_datagen.render_irs_batched(box, cfg, SOURCES, MICS, dirs, device="cpu",
                                                 stats=True)
    executed = info["pair_tests_executed"]
    assert set(executed) == set(port_trace.SWEEP_KINDS)
    assert all(v > 0 for v in executed.values())
    assert info["pair_tests_executed_total"] <= info["pair_tests_issued"]
    timings = info["timings"]
    assert {k for k, v in timings.items() if isinstance(v, float)} == {
        "trace", "bin", "dedup", "finalize", "total"}
    assert executed == {k: timings["counters"][f"pair_tests.{k}"] for k in executed}
    assert info["passes"] == 1 and info["sweeps"] == port_trace.sweep_count(NREFL)


def test_memory_plan_splits_whole_pairs():
    nb, plan = 64, port_datagen.datagen_bytes
    one = plan(1, 4096, 16, 32, 32768, 2)
    assert plan(64, 4096, 16, 32, 32768, 2) > 60 * one
    choose = port_datagen.choose_pairs_per_pass
    assert choose(nb, 4096, 16, 32, 32768, 2) == nb
    assert choose(nb, 4096, 16, 32, 32768, 2, budget=plan(64, 4096, 16, 32, 32768, 2)) == nb
    assert choose(nb, 4096, 16, 32, 32768, 2, budget=20 * one) == 16
    assert choose(nb, 4096, 16, 32, 32768, 2, budget=1) == 1
    assert choose(nb, 4096, 16, 32, 32768, 2, microbatch=5, budget=1) == 5
    with pytest.raises(ValueError, match="microbatch"):
        choose(nb, 4096, 16, 32, 32768, 2, microbatch=0)


@pytest.mark.parametrize("bad", ["bin_mode", "directions", "sources"])
def test_render_irs_batched_refuses_bad_arguments(box, dirs, bad):
    cfg = port_parse_config(_doc())
    kw = {"bin_mode": "dense"} if bad == "bin_mode" else {}
    d = dirs[:, :, :2] if bad == "directions" else dirs
    s = SOURCES[:2] if bad == "sources" else SOURCES
    with pytest.raises(ValueError):
        port_datagen.render_irs_batched(box, cfg, s, MICS, d, device="cpu", **kw)


# ---------------------------------------------------------------------------
# tests/test_datagen.py's inputs unmoved: pair 0 on the symmetry plane x = 0
# ---------------------------------------------------------------------------

PLANE_SOURCES = np.float32([[0, 2, 2], [1, 3, 0], [-2, 5, 1]])
PLANE_MICS = np.float32([[0, 2, 0], [0, 4, 2], [2, 6, -1]])
# the image records of pair 0 on which the packages disagree, (ray, slot):
# the triangle + 1 the port admits there (JAX admits none), and the two
# triangles whose shared diagonal the chain's third reflection point lies
# on (the floor's along z = 0, the ceiling's along x = 0)
PLANE_DISPUTED = {(22, 5): (12, (0, 1)), (82, 5): (7, (10, 11))}
PLANE_BOUNCE_ON_EDGE = 2
PLANE_DISPUTED_SLOT = 5


@pytest.fixture(scope="module")
def plane_traces(box, dirs):
    """Pair 0's single-pair traces at the unmoved inputs: JAX with the XLA
    sweep and with the Pallas kernel (interpret mode), the port with the
    triangle each bounce sweep hit (bounce b is closest-hit call 1 + 2b)
    and the (rows, bounds, Hit) of each sweep."""
    mic, src = PLANE_MICS[0], PLANE_SOURCES[0]
    jsoup = jax_isect.soup_from_scene(box)
    want = {impl: jax_trace.trace_chunk(jsoup, mic, src, dirs[0], nreflections=NREFL, impl=impl)
            for impl in ("xla", "pallas")}
    calls = []
    real = port_trace.closest_hit

    def spy(o, d, soup, **k):
        calls.append((o, d, k.get("t_max"), k.get("t_decide"), real(o, d, soup, **k)))
        return calls[-1][-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_trace, "closest_hit", spy)
        got = port_trace.trace_chunk(port_isect.soup_from_scene(box, device="cpu"), mic, src,
                                     dirs[0], nreflections=NREFL)
    bounce_tris = np.stack([calls[1 + 2 * b][-1].index.numpy()
                            for b in range(min(NREFL, 9))], axis=1)
    return want, got, bounce_tris, calls


def test_symmetry_plane_disagreement_is_pinned(plane_traces):
    """At pair 0 of tests/test_datagen.py, unmoved, the packages' traces
    differ in exactly two image records, both 5th-order images that the
    port admits and the JAX package rejects, with its XLA sweep and with
    its Pallas kernel alike. Every other record agrees at the trace
    tolerances."""
    want, got, _, _ = plane_traces
    xla, pallas = want["xla"], want["pallas"]
    np.testing.assert_array_equal(np.asarray(pallas.image_index), np.asarray(xla.image_index))
    idx_w, idx_g = np.asarray(xla.image_index), got.image_index.numpy()
    assert {tuple(rs) for rs in np.argwhere(idx_w != idx_g).tolist()} == set(PLANE_DISPUTED)
    keep = np.ones(idx_w.shape, bool)
    for (row, slot), (tri1, _) in PLANE_DISPUTED.items():
        assert idx_w[row, slot] == 0 and idx_g[row, slot] == tri1
        keep[row, slot] = False
    for f in ("image_volume", "image_position", "image_time"):
        np.testing.assert_allclose(getattr(got, f).numpy()[keep], np.asarray(getattr(xla, f))[keep],
                                   rtol=0, atol=TRACE_ATOL[f], err_msg=f)
    for f in ("diffuse_volume", "diffuse_position", "diffuse_time"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(xla, f)),
                                   rtol=0, atol=TRACE_ATOL[f], err_msg=f)


def test_symmetry_plane_sweeps_agree_on_the_ports_rows(box, plane_traces):
    """The sweeps are not the cause: the JAX XLA sweep, given the port's own
    rows of the image-phase sweep of the bounce where the disputed images
    arise (shadow, segment and image-visibility rows), returns the port's
    hit verdict on every row it must sweep exactly (t_decide = 0) and the
    port's any-hit verdict on the others; the disputed images come from
    the rows the two packages feed it."""
    *_, calls = plane_traces
    o, d, t_max, t_decide, hit = calls[2 + 2 * (PLANE_DISPUTED_SLOT - 1)]
    want = jax_isect.closest_hit(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                 jax_isect.soup_from_scene(box), t_max=jnp.asarray(t_max.numpy()),
                                 t_decide=jnp.asarray(t_decide.numpy()))
    exact = t_decide.numpy() == 0
    assert exact.sum() > 20
    np.testing.assert_array_equal(np.asarray(want.hit)[exact], hit.hit.numpy()[exact])
    verdict = lambda h, t: ~h | (t > t_decide.numpy())  # noqa: E731
    np.testing.assert_array_equal(verdict(np.asarray(want.hit), np.asarray(want.t))[~exact],
                                  verdict(hit.hit.numpy(), hit.t.numpy())[~exact])
    both = exact & hit.hit.numpy()
    np.testing.assert_allclose(np.asarray(want.t)[both], hit.t.numpy()[both], rtol=0, atol=1e-4)


def _closest_f64(o, d, tris):
    """Float64 Moller-Trumbore over every triangle, edges closed to within
    1e-12 of barycentric: (t, triangle) of each hit beyond EPSILON, by t."""
    from rayverb_tpu_torch.constants import EPSILON

    v0, e0, e1 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    p = np.cross(d, e1)
    det = np.einsum("ij,ij->i", e0, p)
    inv = 1.0 / np.where(det != 0, det, np.inf)  # a parallel triangle: no hit
    tv = o - v0
    u = np.einsum("ij,ij->i", tv, p) * inv
    q = np.cross(tv, e0)
    v = (q @ d) * inv
    t = np.einsum("ij,ij->i", e1, q) * inv
    ok = (det != 0) & (u >= -1e-12) & (v >= -1e-12) & (u + v <= 1 + 1e-12) & (t > EPSILON)
    return sorted(zip(t[ok].tolist(), np.nonzero(ok)[0].tolist()))


def _mirror_f64(p, tri):
    n = np.cross(tri[1] - tri[0], tri[2] - tri[0])
    n /= np.linalg.norm(n)
    return p - n * 2.0 * np.dot(n, p - tri[0])


def test_symmetry_plane_witness_in_float64(box, plane_traces):
    """The witness for the disputed records: the image-source admission of
    each disputed chain redone in float64 on the scene's vertices. The
    chain's third reflection point lies on the diagonal two coplanar
    triangles share (within 1e-9 m), where the segment meets both at one
    t; every segment's closest hit lands on its endpoint and the image is
    visible from the mic, so exact arithmetic admits the image, as the
    port does. In float32 the point sits on a crack that the two packages'
    differently rounded mirror chains fall on either side of; their sweeps
    are not the cause (the JAX package's own two sweeps agree)."""
    from rayverb_tpu_torch.constants import EPSILON

    _, got, bounce_tris, _ = plane_traces
    v0 = np.asarray(box.v0, np.float64)
    tris = np.stack([v0, v0 + np.asarray(box.e0, np.float64),
                     v0 + np.asarray(box.e1, np.float64)], axis=1)
    src, mic = PLANE_SOURCES[0].astype(np.float64), PLANE_MICS[0].astype(np.float64)
    for (row, slot), (tri1, edge) in PLANE_DISPUTED.items():
        chain_idx = bounce_tris[row, :slot]
        assert chain_idx[-1] + 1 == tri1 and chain_idx[PLANE_BOUNCE_ON_EDGE] in edge
        chain = []
        for i in chain_idx:
            cur = tris[i]
            for plane in chain:
                cur = np.stack([_mirror_f64(x, plane) for x in cur])
            chain.append(cur)
        image = mic
        for plane in chain:
            image = _mirror_f64(image, plane)
        d = (image - src) / np.linalg.norm(image - src)
        points = [src]
        for k, plane in enumerate(chain):
            t = _closest_f64(src, d, plane[None])
            assert t and t[0][0] > EPSILON, f"ray {row}: image segment {k} misses its plane"
            p = src + d * t[0][0]
            for prev in chain[k - 1::-1] if k else []:
                p = _mirror_f64(p, prev)
            points.append(p)
        for k in range(slot):
            a, b = points[k], points[k + 1]
            seg = (b - a) / np.linalg.norm(b - a)
            hits = _closest_f64(a, seg, tris)
            assert hits and np.abs(a + seg * hits[0][0] - b).max() < EPSILON, (row, k)
            if k == PLANE_BOUNCE_ON_EDGE:
                ta, tb = (t for t, i in hits if i in edge)
                assert {i for _, i in hits[:2]} == set(edge) and abs(ta - tb) < 1e-9
                va, vb = tris[edge[0]], tris[edge[1]]
                shared = [x for x in va if np.abs(vb - x).max(axis=1).min() < 1e-9]
                assert len(shared) == 2
                axis = (shared[1] - shared[0]) / np.linalg.norm(shared[1] - shared[0])
                off = (b - shared[0]) - axis * np.dot(b - shared[0], axis)
                assert np.linalg.norm(off) < 1e-9, f"ray {row}: {np.linalg.norm(off)} m off"
        last = points[-1]
        dist = np.linalg.norm(mic - last)
        hits = _closest_f64(last, (mic - last) / dist, tris)
        assert not hits or hits[0][0] > dist, f"ray {row}: the image is occluded"
        assert int(got.image_index[row, slot]) == tri1


def _image_chain(verts, mirror_tri, mirror_point, normalize, intersect, stack, src, mic, tris):
    """The trace's image-source admission for the chains of ``tris`` (rows,
    bounces) triangle indices, as ops/trace.py composes it in both
    packages: each bounce's triangle mirrored through the chain before it,
    the mic mirrored through each, the image direction from the source,
    and each segment's single-triangle t (0 where it misses)."""
    chain, image = [], mic
    for k in range(tris.shape[1]):
        cur = verts(tris[:, k])
        for plane in chain:
            cur = mirror_tri(cur, plane)
        chain.append(cur)
        image = mirror_point(image, cur)
    d = normalize(image - src)
    chain = stack(chain)
    return chain, image, d, intersect(src[:, None, :], d[:, None, :], chain)


def test_symmetry_plane_verdict_is_set_by_xla_fusion(box, plane_traces):
    """The cause of the disputed records: the port's image-chain helpers
    (trace._mirror_tri, _mirror_point, _safe_normalize,
    intersect.intersect_triangle) equal the JAX package's own helpers run
    eagerly, bit for bit, at every step of each disputed chain (the
    mirrored chain, the mirrored mic, the image direction and the
    segments' t), and eagerly every segment lands in front, so both admit
    the image. The same composition under jax.jit rounds otherwise
    (fused), and segment 2's t, the reflection on the shared diagonal,
    becomes 0: the JAX trace's rejection comes from how XLA fuses it, not
    from an operation the port could follow."""
    from rayverb_tpu_torch.constants import EPSILON

    _, _, bounce_tris, _ = plane_traces
    rows = sorted(row for row, _ in PLANE_DISPUTED)
    tris = bounce_tris[rows, :PLANE_DISPUTED_SLOT]
    n = len(rows)
    src = np.broadcast_to(PLANE_SOURCES[0], (n, 3)).copy()
    mic = np.broadcast_to(PLANE_MICS[0], (n, 3)).copy()
    jsoup = jax_isect.soup_from_scene(box)

    def jax_chain(s, m, t):
        return _image_chain(jsoup.verts, jax_trace._mirror_tri, jax_trace._mirror_point,
                            jax_trace._safe_normalize, jax_isect.intersect_triangle,
                            lambda c: jnp.stack(c, axis=1), s, m, t)

    j_args = (jnp.asarray(src), jnp.asarray(mic), jnp.asarray(tris))
    eager = [np.asarray(v) for v in jax_chain(*j_args)]
    fused = [np.asarray(v) for v in jax.jit(jax_chain)(*j_args)]
    port = [v.numpy() for v in _image_chain(
        port_isect.soup_from_scene(box, device="cpu").verts, port_trace._mirror_tri,
        port_trace._mirror_point, port_trace._safe_normalize, port_isect.intersect_triangle,
        lambda c: torch.stack(c, dim=1), torch.from_numpy(src), torch.from_numpy(mic),
        torch.from_numpy(tris))]
    for name, e, p in zip(("chain", "image", "direction", "t"), eager, port):
        assert e.dtype == p.dtype == np.float32 and e.tobytes() == p.tobytes(), name
    assert np.all(eager[3] > EPSILON)
    np.testing.assert_array_equal(fused[3][:, PLANE_BOUNCE_ON_EDGE], 0.0)
    others = np.ones(PLANE_DISPUTED_SLOT, bool)
    others[PLANE_BOUNCE_ON_EDGE] = False
    assert np.all(fused[3][:, others] > EPSILON)


def test_symmetry_plane_batch_difference_is_the_disputed_images(box, dirs, monkeypatch):
    """The batch at the unmoved inputs: pairs 1 and 2 within -60 dB of
    JAX's; pair 0 differs by more than a tenth of its peak (0.28 on an
    x86 CPU), and all of that is the two disputed images: with them
    taken out of the port's trace, pair 0 too is within -60 dB."""
    text = _doc()
    want, wc = jax_datagen.render_irs_batched(box, jax_parse_config(text), PLANE_SOURCES,
                                              PLANE_MICS, dirs)
    want = np.asarray(want, np.float64)
    cfg = port_parse_config(text)
    got, gc = port_datagen.render_irs_batched(box, cfg, PLANE_SOURCES, PLANE_MICS, dirs,
                                              device="cpu")
    got = got.numpy().astype(np.float64)
    _assert_within_60db(got[1:], want[1:])
    assert np.abs(got[0] - want[0]).max() > 0.1 * np.abs(want[0]).max()

    real = port_datagen._trace_impl

    def without_disputed(*a, **k):
        vol, pos, tim, idx = real(*a, **k)
        for (row, slot), (tri1, _) in PLANE_DISPUTED.items():
            assert int(k["pair_id"][row]) == 0 and int(idx[row, slot]) == tri1
            vol[row, slot], pos[row, slot], tim[row, slot], idx[row, slot] = 0, 0, 0, 0
        return vol, pos, tim, idx

    monkeypatch.setattr(port_datagen, "_trace_impl", without_disputed)
    fixed, fc = port_datagen.render_irs_batched(box, cfg, PLANE_SOURCES, PLANE_MICS, dirs,
                                                device="cpu")
    _assert_within_60db(fixed.numpy().astype(np.float64), want)
    np.testing.assert_array_equal(fc.numpy(), wc)


def test_render_irs_batched_defaults_to_the_card(box, dirs):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_datagen.render_irs_batched(box, port_parse_config(_doc()), SOURCES, MICS, dirs)
