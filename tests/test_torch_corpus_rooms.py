"""The port's CLI against the JAX package's on the demo corpus's configs
of the models other than random_pillars (echo_tunnel: near_c, far;
bedroom: bedroom, near_l, near_r; vault: vault, vault_l, vault_r), on
the CPU; the criterion, the shared trace records and why are in
tests/test_torch_corpus_cli.py."""

import pytest
import torch

from test_torch_corpus_cli import cli_both, first_combos
from test_torch_render import _assert_within_60db

torch.set_num_threads(1)

CASES = first_combos(exclude=("random_pillars",))


@pytest.mark.parametrize("k, combo", CASES, ids=[c[0] for _, c in CASES])
def test_config_cli_matches_jax(k, combo, tmp_path, monkeypatch):
    got, want = cli_both(k, combo, tmp_path, monkeypatch=monkeypatch)
    _assert_within_60db(got, want)
