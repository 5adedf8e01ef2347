"""Threefry keys and uniform draws of the port against jax.random.

Tolerance: bitwise.  The draws are integer hashes and an exact
bit-to-float step; any difference would change the RANSAC hypotheses.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_video_stabilizer_tpu_torch.ops import prng  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 2, 7, 12345, 2**31 - 1])
def test_prngkey_matches(seed):
    assert np.array_equal(np.asarray(jax.random.PRNGKey(seed)), prng.keys_to_jax(prng.PRNGKey(seed)))


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_fold_in_keys_match(seed):
    pairs = jnp.arange(79)
    ref = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed), i))(pairs)
    ours = prng.fold_in(prng.PRNGKey(seed), torch.arange(79))
    assert np.array_equal(np.asarray(ref), prng.keys_to_jax(ours))


@pytest.mark.parametrize("seed,shape", [(1, (512, 2)), (0, (512, 2)), (5, (512, 4)),
                                        (3, (7,)), (9, (33, 5))])
def test_uniform_matches(seed, shape):
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed), i))(jnp.arange(6))
    ref = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(keys))
    ours = prng.uniform(prng.keys_from_jax(np.asarray(keys)), shape).numpy()
    assert ours.dtype == np.float32
    assert np.array_equal(ref.view(np.uint32), ours.view(np.uint32))


def test_keys_round_trip():
    keys = np.asarray(jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(3), i))(jnp.arange(4)))
    assert np.array_equal(prng.keys_to_jax(prng.keys_from_jax(keys)), keys)
    assert prng.keys_from_jax(keys).dtype == torch.int64
