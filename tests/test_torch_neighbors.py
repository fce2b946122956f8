"""The port's ``ops/neighbors.py`` against the JAX package's on seeded
inputs: ``pairwise_distances`` (with and without the differences, and the
1e-8 clip on coincident points), ``knn_points`` and ``knn_gather``; on
integer-grid points, whose distances tie exactly, ``knn_points`` returns
JAX's indices (the lower index first, as ``jax.lax.top_k`` orders them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepflowww_tpu.ops import neighbors as jn

from pepflowww_torch.ops import neighbors as tn


def _points(kind: str):
    rng = np.random.default_rng(11)
    if kind == "normal":
        q = rng.normal(size=(2, 7, 3)).astype(np.float32)
        p = rng.normal(size=(2, 9, 3)).astype(np.float32)
    else:   # a 3x3x3 grid: many exactly equal distances, queries on grid points too
        grid = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"), -1).reshape(-1, 3)
        p = np.stack([grid, grid[::-1]]).astype(np.float32)
        q = np.stack([grid[[0, 4, 13, 26, 13]], grid[[1, 13, 2, 2, 9]]]).astype(np.float32)
    return q, p


@pytest.mark.parametrize("kind", ["normal", "grid"])
def test_pairwise_distances_match_jax(kind):
    q, p = _points(kind)
    for y in (None, p):
        x = q if y is not None else p
        want_d, want_v = jn.pairwise_distances(jnp.asarray(x), None if y is None
                                               else jnp.asarray(y), return_v=True)
        got_d, got_v = tn.pairwise_distances(torch.from_numpy(x), None if y is None
                                             else torch.from_numpy(y), return_v=True)
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        got = tn.pairwise_distances(torch.from_numpy(x), None if y is None
                                    else torch.from_numpy(y))
        assert torch.equal(got, got_d)
    # coincident points: the clip, not a zero
    assert float(tn.pairwise_distances(torch.from_numpy(p))[0, 0, 0]) == pytest.approx(1e-4)


@pytest.mark.parametrize("kind,K", [("normal", 4), ("normal", 20), ("grid", 7), ("grid", 27)])
def test_knn_points_and_gather_match_jax(kind, K):
    """The distances, the indices (equal to JAX's, ties included) and the
    gathered neighbours; K above N takes every point."""
    q, p = _points(kind)
    want = jn.knn_points(jnp.asarray(q), jnp.asarray(p), K)
    got = tn.knn_points(torch.from_numpy(q), torch.from_numpy(p), K)
    k = min(K, p.shape[1])
    for g, w, shape in zip(got, want, [(2, q.shape[1], k), (2, q.shape[1], k),
                                       (2, q.shape[1], k, 3)]):
        assert tuple(g.shape) == shape == tuple(w.shape)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if kind == "grid":   # the case the stable order is for: equal distances present
        d = got[0].numpy()
        assert (np.diff(d, axis=-1) == 0).any()
    idx = torch.from_numpy(np.asarray(want[1])[:, :, ::-1].copy())
    np.testing.assert_array_equal(tn.knn_gather(idx, torch.from_numpy(p)).numpy(),
                                  np.asarray(jn.knn_gather(jnp.asarray(idx.numpy()),
                                                           jnp.asarray(p))))
