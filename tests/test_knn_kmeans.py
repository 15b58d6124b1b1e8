"""Exact kNN and KMeans kernels vs NumPy oracles."""
import numpy as np
import pytest

from otto_tpu.ops.kmeans import kmeans_fit
from otto_tpu.ops.knn import corpus_tile, knn_search

RNG = np.random.default_rng(0)


def test_knn_l2_matches_bruteforce():
    V, Q, D, k = 500, 40, 16, 5
    corpus = RNG.normal(size=(V, D)).astype(np.float32)
    queries = corpus[:Q]
    scores, idx = knn_search(queries, corpus, k, metric="l2", tile=128)
    d = ((queries[:, None, :] - corpus[None, :, :]) ** 2).sum(-1)
    ref_idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    # self must be the nearest neighbour
    assert np.array_equal(idx[:, 0], np.arange(Q))
    # distances match (ordering may differ on exact ties)
    got_d = np.sort(-scores, axis=1)
    want_d = np.sort(np.take_along_axis(d, ref_idx, 1), axis=1)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-4, atol=1e-4)


def test_knn_dot():
    V, D, k = 300, 8, 3
    corpus = RNG.normal(size=(V, D)).astype(np.float32)
    queries = RNG.normal(size=(7, D)).astype(np.float32)
    scores, idx = knn_search(queries, corpus, k, metric="dot", tile=64)
    s = queries @ corpus.T
    ref = np.sort(s, axis=1)[:, ::-1][:, :k]
    np.testing.assert_allclose(np.asarray(scores), ref, rtol=1e-4, atol=1e-4)


def _ref_scores(queries, corpus, metric):
    q, c = queries.astype(np.float64), corpus.astype(np.float64)
    if metric == "cos":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        c = c / np.linalg.norm(c, axis=1, keepdims=True)
    if metric == "l2":
        return -((q[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    return q @ c.T


@pytest.mark.parametrize("metric", ["l2", "dot", "cos"])
@pytest.mark.parametrize(
    "V,k",
    [(100, 5),    # corpus smaller than one tile
     (300, 7),    # corpus not a multiple of the tile (3 tiles of 128)
     (4, 6)],     # fewer corpus rows than k
)
def test_knn_search_matches_float64(metric, V, k):
    rng = np.random.default_rng(V + k)
    corpus = rng.normal(size=(V, 12)).astype(np.float32)
    queries = rng.normal(size=(9, 12)).astype(np.float32)
    scores, idx = knn_search(queries, corpus, k, metric=metric, tile=128)
    ref = _ref_scores(queries, corpus, metric)
    kk = min(k, V)
    want = -np.sort(-ref, axis=1)[:, :kk]
    np.testing.assert_allclose(scores[:, :kk], want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.take_along_axis(ref, idx[:, :kk], 1), want,
                               rtol=1e-4, atol=1e-4)
    # missing neighbours: score -inf, index -1 (never a padding row id)
    assert np.all(idx[:, kk:] == -1)
    assert np.all(np.isneginf(scores[:, kk:]))


@pytest.mark.parametrize("Q", [37, 32, 5])
def test_knn_search_query_block_padding(Q):
    """Blocks padded to query_block rows give the single-block answer."""
    rng = np.random.default_rng(Q)
    corpus = rng.normal(size=(200, 8)).astype(np.float32)
    queries = rng.normal(size=(Q, 8)).astype(np.float32)
    s1, i1 = knn_search(queries, corpus, 4, query_block=1024)
    s2, i2 = knn_search(queries, corpus, 4, query_block=16)
    assert s2.shape == (Q, 4) and i2.shape == (Q, 4)
    np.testing.assert_allclose(s1, s2, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(i1, i2)


@pytest.mark.parametrize("n,want", [(1, 128), (100, 128), (300, 512),
                                    (5000, 8192), (1_800_000, 8192)])
def test_corpus_tile(n, want):
    assert corpus_tile(n) == want


def test_kmeans_separates_blobs():
    centers = np.array([[0, 0], [10, 10], [-10, 10]], np.float32)
    x = np.concatenate(
        [c + RNG.normal(scale=0.5, size=(100, 2)) for c in centers]
    ).astype(np.float32)
    cents, labels, inertia, n_iter = kmeans_fit(x, 3, max_iter=50, seed=1)
    # each blob maps to a single cluster
    for b in range(3):
        blob_labels = labels[b * 100 : (b + 1) * 100]
        assert len(np.unique(blob_labels)) == 1
    assert inertia < 3 * 100 * 2 * 1.0  # tight clusters
    assert n_iter < 50


def test_kmeans_dp_separates_blobs():
    """8-way data-parallel fit (shard_map + per-step psum) clusters the
    same blobs to the same quality as the single-device fit."""
    import jax

    from otto_tpu.ops.kmeans import kmeans_fit_dp
    from otto_tpu.parallel.mesh import make_mesh

    centers = np.array([[0, 0], [10, 10], [-10, 10]], np.float32)
    x = np.concatenate(
        [c + RNG.normal(scale=0.5, size=(128, 2)) for c in centers]
    ).astype(np.float32)
    perm = RNG.permutation(len(x))  # spread blobs across shards
    ctx = make_mesh(jax.devices()[:8], data_parallel=8)
    cents, labels_p, inertia, n_iter = kmeans_fit_dp(
        x[perm], 3, ctx.mesh, axis="data", max_iter=50, seed=1
    )
    labels = np.empty(len(x), np.int32)
    labels[perm] = labels_p
    for b in range(3):
        blob_labels = labels[b * 128 : (b + 1) * 128]
        assert len(np.unique(blob_labels)) == 1
    assert inertia < 3 * 128 * 2 * 1.0
    assert n_iter < 50
