"""The port's generator on configurations other than the face preset's,
against the JAX package on the CPU: the branches the face slice does not
take.  Same setup and tolerances as tests/test_torch_generator.py.

  resref_nowarp: K = 2, residual reference encoder, no reference warp and
    no SPADE-combine (the blend with the warped previous frame), a separate
    temporal flow network;
  shared_raw: K = 1, the raw-output branch (add_raw_output_loss), one
    embedding network shared by the reference and previous warps, separate
    flow networks.
"""
import pytest

from tests.test_torch_generator import (
    Pair, run_forward_with_prefix, run_sequence_matches)

VARIANTS = {
    "resref_nowarp": dict(n_shot=2, res_for_ref=True, warp_ref=False,
                          spade_combine=False),
    "shared_raw": dict(n_shot=1, add_raw_output_loss=True, no_sep_warp_embed=True,
                       sep_flow_prev=True),
}
_PAIRS = {}


@pytest.fixture(params=sorted(VARIANTS))
def pair(request):
    if request.param not in _PAIRS:
        _PAIRS[request.param] = Pair(seed=7, **VARIANTS[request.param])
    return _PAIRS[request.param]


def test_variant_run_sequence_matches_jax(pair):
    run_sequence_matches(pair)


def test_variant_forward_with_prefix_matches_jax(pair):
    run_forward_with_prefix(pair)
