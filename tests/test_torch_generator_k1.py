"""The port's K = 1 face path against the JAX package on the CPU, at
tiny_face_cfg size: the whole clip (run_sequence), the forward with a
prefix, and the K = 1 serving cache (encode_reference + synthesize).  Same
setup and tolerances as tests/test_torch_generator.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_generator import (
    FLOW_ATOL, IMG_ATOL, get_pair, nchw, nhwc, run_forward_with_prefix,
    run_sequence_matches)


def test_run_sequence_matches_jax_k1():
    """T = 3 frames: frame 0 without prevs, then warp_prev."""
    run_sequence_matches(get_pair(1))


def test_forward_with_prefix_matches_jax_k1():
    run_forward_with_prefix(get_pair(1))


def test_encode_reference_synthesize_matches_jax():
    """The K = 1 serving cache: encode_reference once, then synthesize with
    a previous frame."""
    pair = get_pair(1)
    jm = pair.jm
    args = tuple(map(jnp.asarray, (pair.labels[1], pair.ref_labels,
                                   pair.ref_images, pair.labels[0],
                                   pair.prev_image)))

    @jax.jit
    def jax_synth(v, label, label_refs, img_refs, prev_l, prev_i):
        cache = jm.apply(v, label_refs, img_refs, label,
                         method=jm.encode_reference)
        return jm.apply(v, label, label_refs, img_refs, cache, prev_l, prev_i,
                        warp_prev=True, method=jm.synthesize)

    want = jax_synth(pair.folded, *args)
    with torch.no_grad():
        cache = pair.g.encode_reference(nchw(pair.ref_labels),
                                        nchw(pair.ref_images), nchw(pair.labels[1]))
        got = pair.g.synthesize(*map(nchw, (pair.labels[1], pair.ref_labels,
                                            pair.ref_images)), cache,
                                nchw(pair.labels[0]), nchw(pair.prev_image),
                                warp_prev=True)
    np.testing.assert_allclose(nhwc(got["img_final"]), np.asarray(want["img_final"]),
                               atol=IMG_ATOL)
    for j in range(2):
        np.testing.assert_allclose(nhwc(got["flow"][j]), np.asarray(want["flow"][j]),
                                   atol=FLOW_ATOL)
        np.testing.assert_allclose(nhwc(got["img_warp"][j]),
                                   np.asarray(want["img_warp"][j]), atol=IMG_ATOL)
