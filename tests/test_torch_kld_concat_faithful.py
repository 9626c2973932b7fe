"""Step 1 of `train_step_faithful` with the VAE bottleneck and concatenated reference
labels against the JAX package's, on the CPU in f32 at
tests/test_torch_kld_concat.py's tiny configuration: every loss, G_KLD
included, 1e-4 relative (`check_step_one` there).  The JAX step's compile
takes minutes, so each step has a file of its own and the two run on
separate pytest-xdist workers.
"""
import pytest

from tests.test_torch_kld_concat import OPTIONS, check_step_one
from tests.test_torch_train_step import make_shared


@pytest.fixture(scope="module")
def shared():
    return make_shared(**OPTIONS)


@pytest.mark.parametrize("name", ["train_step_faithful"])
def test_step_one_losses_match_jax(shared, name):
    check_step_one(shared, name)
