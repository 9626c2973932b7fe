"""The port's crop_resize and paste_region (fsvid2vid_tpu_torch/ops/crop.py)
against the JAX ops on the CPU: values and gradients (of a random linear
function of the output, with respect to the image and the patch) agree to
1e-5, f32 sums of four bilinear taps.  Boxes include ones that run past the
border on every side, a box smaller than its output (upsampling) and one
with fractional corners."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.ops.crop import crop_resize as jcrop, paste_region as jpaste
from fsvid2vid_tpu_torch.ops.crop import crop_resize, paste_region

ATOL = 1e-5
B, H, W, C = 4, 24, 20, 3
BOXES = np.array([[2, 18, 3, 15],          # inside
                  [-6, 10, -4, 12],        # past the top and the left
                  [12, 31, 9, 27],         # past the bottom and the right
                  [5.5, 9.25, 7.75, 11]],  # small and fractional: upsampled
                 np.float32)


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("out_size", [(8, 8), (16, 12)])
def test_crop_resize_values_and_gradients(rng, out_size):
    image = rng.randn(B, H, W, C).astype(np.float32)
    cot = rng.randn(B, *out_size, C).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jcrop(x, jnp.asarray(BOXES), out_size), jnp.asarray(image))
    (want_grad,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(image).requires_grad_()
    got = crop_resize(x, torch.from_numpy(BOXES), out_size)
    close(got, want)
    (got * torch.from_numpy(cot)).sum().backward()
    close(x.grad, want_grad)
    assert np.abs(np.asarray(want_grad)).max() > 0.1


def test_paste_region_values_and_gradients(rng):
    canvas = rng.randn(B, H, W, C).astype(np.float32)
    patch = rng.randn(B, 8, 8, C).astype(np.float32)
    cot = rng.randn(B, H, W, C).astype(np.float32)
    f = lambda c, p: jpaste(c, p, jnp.asarray(BOXES))
    want, vjp = jax.vjp(f, jnp.asarray(canvas), jnp.asarray(patch))
    want_gc, want_gp = vjp(jnp.asarray(cot))
    c = torch.from_numpy(canvas).requires_grad_()
    p = torch.from_numpy(patch).requires_grad_()
    got = paste_region(c, p, torch.from_numpy(BOXES))
    close(got, want)
    (got * torch.from_numpy(cot)).sum().backward()
    close(c.grad, want_gc)
    close(p.grad, want_gp)
    # outside the box the canvas passes through untouched
    assert torch.equal(got[0, 0], c[0, 0]) and torch.equal(got[0, :, 19], c[0, :, 19])


def test_crop_of_a_paste(rng):
    """A patch pasted into a box and cropped back out of it, as the face
    refiner's paste and a later crop compose."""
    canvas = torch.from_numpy(rng.randn(1, H, W, C).astype(np.float32))
    patch = torch.from_numpy(rng.randn(1, 8, 6, C).astype(np.float32))
    box = torch.tensor([[4.0, 20.0, 2.0, 14.0]])
    back = crop_resize(paste_region(canvas, patch, box), box, (8, 6))
    want = jcrop(jpaste(jnp.asarray(canvas.numpy()), jnp.asarray(patch.numpy()),
                        jnp.asarray(box.numpy())), jnp.asarray(box.numpy()), (8, 6))
    close(back, want)
