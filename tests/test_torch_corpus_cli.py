"""The port's CLI against the JAX package's on the demo corpus's configs,
on the CPU: the configs rendered on random_pillars (the first combination
of hrtf_vault, hrtf_vault_l, hrtf_vault_r, oct, medium and far_2 in
COMBOS). tests/test_torch_corpus_rooms.py has the configs of the other
models and tests/test_torch_corpus_materials.py the five materials.

Each case takes its config file with rays -> 256 and reflections -> 16 and
nothing else changed (speakers or HRTF, filter, trims, hipass, output
mode, bit depth, sample rate), renders it through rayverb_tpu.cli.main and
rayverb_tpu_torch.cli.main --device cpu with the corpus's seed (the
combination's index in COMBOS), and holds the read-back WAVs to equal
format and to -60 dB of peak (tests/test_torch_render.py's
_assert_within_60db).

Both renders bin the JAX trace's records (the port's trace is replaced by
the JAX trace of the same rays, as in tests/test_torch_hrtf.py), so the
cases hold everything after the trace: attenuation, binning, image dedup,
filters, trims, mixdown and the WAV. On their own traces the two CLIs
differ beyond -60 dB on most of the corpus's configs at this size, for
two reasons that tests/test_torch_corpus_materials.py::
test_own_trace_difference_is_edge_verdicts_and_bin_edges takes apart:
  - image-source verdicts on triangle edges. The corpus's sources and mics
    sit on the models' symmetry planes, where an image chain's reflection
    point can land on a shared edge; the port's, XLA's and float64's
    arithmetic each round such a verdict their own way, and a disputed
    image is a whole specular arrival;
  - diffuse arrival times that agree to ~1e-7 s (the trace tolerances of
    tests/test_torch_trace.py) but lie on either side of a 44.1 kHz bin
    edge; at 256 rays one arrival is a few hundredths of the peak, beyond
    the single-bin forgiveness of the -60 dB rule (ROADMAP Queue 3
    item 4).
The port's own trace is held record by record in tests/test_torch_trace.py
and on the card against the corpus itself (gen --check-against).
"""

import json

import pytest
import torch

from rayverb_tpu import cli as jax_cli
from rayverb_tpu import load_scene
from rayverb_tpu_torch import cli as port_cli
from rayverb_tpu_torch import gen
from rayverb_tpu_torch.io.audio import read_audio

from test_torch_render import _assert_within_60db, feed_jax_trace

torch.set_num_threads(1)

RAYS, REFLECTIONS = 256, 16


def first_combos(model=None, exclude=()):
    """(k, combo) of each config's first combination in COMBOS, where that
    combination renders ``model`` (None: any) and not a model in
    ``exclude``."""
    first = {}
    for k, combo in enumerate(gen.COMBOS):
        first.setdefault(combo[0], (k, combo))
    return [(k, c) for k, c in first.values()
            if (model is None or c[1] == model) and c[1] not in exclude]


def reduced_config(combo, tmp_path):
    """The combination's config file with rays and reflections cut down,
    written into ``tmp_path``; returns (path, the parsed document)."""
    doc = json.load(open(gen.combo_paths(combo)[0]))
    doc.update(rays=RAYS, reflections=REFLECTIONS)
    path = tmp_path / f"{combo[0]}.json"
    path.write_text(json.dumps(doc))
    return str(path), doc


def cli_both(k, combo, tmp_path, *, shared=True, monkeypatch=None):
    """Render the reduced combination through both CLIs with seed ``k``;
    with ``shared`` the port bins the JAX trace's records. Returns (port,
    JAX) read-back channels after checking that their formats agree."""
    cfg, doc = reduced_config(combo, tmp_path)
    _, model, materials = gen.combo_paths(combo)
    if shared:
        feed_jax_trace(monkeypatch, load_scene(model, materials))
    args = [cfg, model, materials]
    assert jax_cli.main(args + [str(tmp_path / "jax.wav"), "--seed", str(k)]) == 0
    assert port_cli.main(args + [str(tmp_path / "port.wav"), "--seed", str(k),
                                 "--device", "cpu"]) == 0
    want, want_sr, want_bits = read_audio(str(tmp_path / "jax.wav"))
    got, got_sr, got_bits = read_audio(str(tmp_path / "port.wav"))
    assert (got.shape[0], got_sr, got_bits) == (want.shape[0], want_sr, want_bits)
    assert (want_sr, want_bits) == (doc["sample_rate"], doc["bit_depth"])
    return got, want


CASES = first_combos("random_pillars")


@pytest.mark.parametrize("k, combo", CASES, ids=[c[0] for _, c in CASES])
def test_config_cli_matches_jax(k, combo, tmp_path, monkeypatch):
    got, want = cli_both(k, combo, tmp_path, monkeypatch=monkeypatch)
    _assert_within_60db(got, want)


def test_cases_cover_every_config():
    """The three files' cases together take every config of COMBOS once."""
    rooms = first_combos(exclude=("random_pillars",))
    configs = [c[0] for _, c in CASES + rooms]
    assert sorted(configs) == sorted({c[0] for c in gen.COMBOS})
    assert len(CASES) == 6 and len(rooms) == 8
