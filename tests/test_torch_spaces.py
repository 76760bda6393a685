"""The port's spaces against the JAX package's, and their device samplers."""

import numpy as np
import pytest
import torch

from gymnasium_tpu import spaces as jspaces
from gymnasium_tpu.vector.utils import batch_space as jax_batch_space
from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.utils import seeding
from gymnasium_tpu_torch.vector.utils import batch_space

INF = np.inf
BOXES = [
    (-1.0, 1.0, (3,), np.float32),
    (np.array([-INF, 0, -INF, -1], np.float32), np.array([INF, INF, 2, 1], np.float32), None, np.float32),
    (0, 9, (2, 2), np.int32),
]


@pytest.mark.parametrize("low, high, shape, dtype", BOXES)
def test_box_host_half_matches_jax(low, high, shape, dtype):
    box, jbox = spaces.Box(low, high, shape, dtype, seed=4), jspaces.Box(low, high, shape, dtype, seed=4)
    assert repr(box) == repr(jbox)
    np.testing.assert_array_equal(box.low, jbox.low)
    np.testing.assert_array_equal(box.bounded_below, jbox.bounded_below)
    np.testing.assert_array_equal(box.sample(), jbox.sample())  # same PCG64 stream
    for manner in ("both", "below", "above"):
        assert box.is_bounded(manner) == jbox.is_bounded(manner)
    x = jbox.sample()
    assert box.contains(x) and jbox.contains(x)


@pytest.mark.parametrize("low, high, shape, dtype", BOXES)
def test_box_sample_torch_respects_bounds(low, high, shape, dtype):
    box = spaces.Box(low, high, shape, dtype)
    g = torch.Generator().manual_seed(0)
    x = box.sample_torch(g, (4096,))
    assert x.shape == (4096,) + box.shape
    assert x.dtype == (torch.float32 if np.dtype(dtype).kind == "f" else torch.int32)
    assert bool(box.contains_torch(x))
    bounded = torch.from_numpy(box.bounded_below & box.bounded_above)
    if bounded.all() and np.dtype(dtype).kind == "f":
        mid = torch.from_numpy((box.low + box.high) / 2)
        se = torch.from_numpy((box.high - box.low) / np.sqrt(12 * 4096))
        assert ((x.mean(0) - mid).abs() < 4 * se).all()


def test_discrete_matches_jax_and_samples_int32():
    d, jd = spaces.Discrete(5, seed=2, start=3), jspaces.Discrete(5, seed=2, start=3)
    assert repr(d) == repr(jd) and d.sample() == jd.sample()
    assert d.contains(np.int64(4)) and not d.contains(np.int64(8))
    x = d.sample_torch(torch.Generator().manual_seed(1), (10000,))
    assert x.dtype == torch.int32 and x.shape == (10000,)
    assert bool(d.contains_torch(x).all())
    counts = torch.bincount(x - 3, minlength=5).double()
    se = np.sqrt(10000 * 0.2 * 0.8)
    assert ((counts - 2000).abs() < 4 * se).all()


def test_batch_space_matches_jax():
    for space, jspace in [
        (spaces.Box(-1.0, 1.0, (3,)), jspaces.Box(-1.0, 1.0, (3,))),
        (spaces.Discrete(4, start=1), jspaces.Discrete(4, start=1)),
    ]:
        b, jb = batch_space(space, 6), jax_batch_space(jspace, 6)
        assert repr(b) == repr(jb) and b.shape == jb.shape
    md = batch_space(spaces.Discrete(3), 8)
    x = md.sample_torch(torch.Generator(), (100,))
    assert x.shape == (100, 8) and bool(md.contains_torch(x))
    assert md.contains(md.sample())
    with pytest.raises(TypeError):
        batch_space(md, 2)


def test_seeding_matches_jax_host_seeding():
    from gymnasium_tpu.utils import seeding as jseeding

    rng, entropy = seeding.np_random(11)
    jrng, jentropy = jseeding.np_random(11)
    assert entropy == jentropy and rng.integers(1 << 30) == jrng.integers(1 << 30)
    with pytest.raises(Exception, match="non-negative"):
        seeding.np_random(-1)
