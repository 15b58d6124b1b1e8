"""GBDT lambdarank (models/gbdt.py) against NumPy oracles + learning checks."""
import jax.numpy as jnp
import numpy as np
import pytest

from otto_tpu.models.gbdt import (
    GBDTConfig,
    GBDTRanker,
    _histograms,
    _lambda_grads_chunk,
    _max_dcg,
    bin_features,
    compute_bin_edges,
    train_gbdt_ranker,
)
from otto_tpu.models.ranker import ndcg_at_k


def test_binning_roundtrip():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5000, 6)).astype(np.float32)
    x[:, 3] = 7.0  # constant feature
    edges = compute_bin_edges(x, n_bins=16)
    b = bin_features(x, edges)
    assert b.dtype == np.uint8
    assert b.max() < 16
    # monotone: larger value -> bin id never decreases
    order = np.argsort(x[:, 0])
    assert (np.diff(b[order, 0].astype(int)) >= 0).all()
    # constant feature lands in a single bin
    assert len(np.unique(b[:, 3])) == 1


def test_histogram_matches_bincount_oracle():
    rng = np.random.default_rng(1)
    n, f, bins, w = 1000, 5, 8, 2
    bn = rng.integers(0, bins, size=(n, f)).astype(np.uint8)
    node = rng.integers(0, w, size=n).astype(np.int32)
    gh3 = rng.normal(size=(n, 3)).astype(np.float32)
    h = np.asarray(_histograms(
        jnp.asarray(bn), jnp.asarray(node), jnp.asarray(gh3), w, bins, 256
    ))
    # oracle: the node-weighted gradient block the kernel builds per chunk
    ghc = (
        (node[:, None] == np.arange(w))[:, :, None] * gh3[:, None, :]
    ).reshape(n, w * 3)
    for fi in range(f):
        for di in range(w * 3):
            oracle = np.bincount(bn[:, fi], weights=ghc[:, di], minlength=bins)
            # operands are bf16-quantized (f32 accumulate): |err| ~ 2^-9 *
            # sqrt(n_per_bin) in units of the summand scale
            np.testing.assert_allclose(h[fi, :, di], oracle, rtol=5e-2, atol=1e-1)


def test_lambda_grads_push_positives_up():
    # 2 groups, G=4: positives should get negative gradient (score increases
    # via leaf = -G/H), zero-sum within each group
    scores = jnp.zeros((2, 4))
    labels = jnp.asarray([[1, 0, 0, 0], [0, 0, 1, 0]], jnp.float32)
    mask = jnp.ones((2, 4), bool)
    maxdcg = _max_dcg(labels, mask, 20)
    g, h = _lambda_grads_chunk(scores, labels, mask, maxdcg, 1.0, 20, True)
    g, h = np.asarray(g), np.asarray(h)
    assert g[0, 0] < 0 and g[1, 2] < 0
    assert (g[0, 1:] > 0).all()
    np.testing.assert_allclose(g.sum(axis=1), 0.0, atol=1e-6)
    assert (h >= 0).all()


def _synthetic_ranking(n_groups=300, g=16, f=10, seed=0):
    """Relevance depends on a nonlinear feature interaction."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_groups * g, f)).astype(np.float32)
    logits = (x[:, 0] > 0.3) * 2.0 + x[:, 1] * (x[:, 2] > 0) - 0.5 * x[:, 3]
    sess = np.repeat(np.arange(n_groups), g).astype(np.int64)
    y = np.zeros(n_groups * g, np.float32)
    for s in range(n_groups):
        rows = slice(s * g, (s + 1) * g)
        top = np.argsort(-logits[rows])[:3]
        yy = np.zeros(g, np.float32)
        yy[top] = 1.0
        y[rows] = yy
    return x, y, sess


def test_gbdt_learns_ranking_and_beats_random():
    x, y, sess = _synthetic_ranking()
    cfg = GBDTConfig(
        n_trees=30, max_depth=3, n_bins=16, colsample=0.8, subsample=0.9,
        min_child_samples=5, max_group=16, row_chunk=512, group_chunk=64,
    )
    model = train_gbdt_ranker(x, y, sess, tuple(f"f{i}" for i in range(10)), cfg)
    scores = model.predict(x).reshape(-1, 16)
    yg = y.reshape(-1, 16)
    mask = np.ones_like(yg, bool)
    nd = ndcg_at_k(scores, yg, mask, 20)
    rng = np.random.default_rng(3)
    nd_rand = ndcg_at_k(rng.normal(size=scores.shape), yg, mask, 20)
    assert nd > 0.8, f"gbdt ndcg {nd} too low (random={nd_rand})"
    assert nd > nd_rand + 0.3


def test_gbdt_save_load_roundtrip(tmp_path):
    x, y, sess = _synthetic_ranking(n_groups=50)
    cfg = GBDTConfig(
        n_trees=5, max_depth=3, n_bins=16, colsample=0.8, subsample=1.0,
        min_child_samples=5, max_group=16, row_chunk=512, group_chunk=32,
    )
    model = train_gbdt_ranker(x, y, sess, tuple(f"f{i}" for i in range(10)), cfg)
    p = str(tmp_path / "gbdt.npz")
    model.save(p)
    loaded = GBDTRanker.load(p)
    np.testing.assert_allclose(model.predict(x[:100]), loaded.predict(x[:100]))
    imp = model.feature_importance()
    assert imp.shape == (10,) and imp.sum() > 0
    # gain importance: positive where split counts are, preserved on load
    gain = model.feature_importance("gain")
    split = model.feature_importance("split")
    assert gain.shape == (10,) and gain.sum() > 0
    assert np.all((gain > 0) == (split > 0))
    np.testing.assert_allclose(loaded.feature_importance("gain"), gain)


def test_gbdt_periodic_eval_and_best_iter():
    """Valid ndcg@20 is evaluated every eval_every trees (reference logs
    eval every 25 iterations, config.py:223-227) and best_iter/best_score
    are recorded (reference: utils.py:77-93). The accumulated-score eval
    path must agree with full re-prediction at each point."""
    x, y, sess = _synthetic_ranking(n_groups=200)
    xv, yv, sv = _synthetic_ranking(n_groups=60, seed=5)
    cfg = GBDTConfig(
        n_trees=20, max_depth=3, n_bins=16, colsample=0.8, subsample=0.9,
        min_child_samples=5, max_group=16, row_chunk=512, group_chunk=64,
        eval_every=5, trees_per_dispatch=10,
    )
    model = train_gbdt_ranker(
        x, y, sess, tuple(f"f{i}" for i in range(10)), cfg,
        valid=(xv, yv, sv),
    )
    hist = model.eval_history
    assert [n for n, _ in hist] == [5, 10, 15, 20]
    assert model.best_iter == max(hist, key=lambda e: e[1])[0]
    assert abs(model.best_score - max(n for _, n in hist)) < 1e-9
    # accumulated valid scores == full re-prediction at the final point
    scores = model.predict(xv).reshape(-1, 16)
    nd_full = float(ndcg_at_k(scores, yv.reshape(-1, 16),
                              np.ones((60, 16), bool), cfg.ndcg_at))
    # accumulated per-chunk score sums differ from one-shot prediction only
    # by f32 summation order; near-tie rank flips bound the ndcg delta
    assert abs(hist[-1][1] - nd_full) < 5e-3

    # save/load round-trips best_iter/best_score
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "m.npz")
        model.save(p)
        loaded = GBDTRanker.load(p)
        assert loaded.best_iter == model.best_iter
        assert abs(loaded.best_score - model.best_score) < 1e-12


def test_gbdt_early_stopping_truncates_to_best():
    """With early_stopping_rounds set, training stops once valid ndcg stalls
    and the kept model has exactly best_iter trees."""
    x, y, sess = _synthetic_ranking(n_groups=150)
    xv, yv, sv = _synthetic_ranking(n_groups=50, seed=9)
    cfg = GBDTConfig(
        n_trees=60, max_depth=3, n_bins=16, colsample=0.8, subsample=0.9,
        min_child_samples=5, max_group=16, row_chunk=512, group_chunk=64,
        eval_every=5, trees_per_dispatch=10, early_stopping_rounds=10,
    )
    model = train_gbdt_ranker(
        x, y, sess, tuple(f"f{i}" for i in range(10)), cfg,
        valid=(xv, yv, sv),
    )
    if len(model.eval_history) < 60 // 5:  # stopped early
        assert len(model.leaf) == model.best_iter
    # predictions still work after truncation
    assert np.isfinite(model.predict(x[:64])).all()


def test_gbdt_data_parallel_matches_quality():
    """8-way dp training (shard_map + histogram psum) learns the same task
    to the same quality as single-device training."""
    import jax

    from otto_tpu.parallel.mesh import make_mesh

    x, y, sess = _synthetic_ranking(n_groups=320, g=16, seed=5)
    cfg = GBDTConfig(
        n_trees=25, max_depth=3, n_bins=16, colsample=0.8, subsample=0.9,
        min_child_samples=5, max_group=16, row_chunk=512, group_chunk=8,
    )
    names = tuple(f"f{i}" for i in range(10))
    ctx = make_mesh(jax.devices()[:8], data_parallel=8)
    model_dp = train_gbdt_ranker(x, y, sess, names, cfg, mesh=ctx.mesh)
    model_1 = train_gbdt_ranker(x, y, sess, names, cfg)

    yg = y.reshape(-1, 16)
    mask = np.ones_like(yg, bool)
    nd_dp = ndcg_at_k(model_dp.predict(x).reshape(-1, 16), yg, mask, 20)
    nd_1 = ndcg_at_k(model_1.predict(x).reshape(-1, 16), yg, mask, 20)
    assert nd_dp > 0.8, f"dp ndcg {nd_dp} (single {nd_1})"
    assert abs(nd_dp - nd_1) < 0.1


def test_gbdt_dp_histogram_reduction_exact():
    """psum of per-shard histograms == global bincount oracle (dp
    correctness at the primitive level, independent of tree decisions)."""
    import jax
    import jax.numpy as jnp
    from functools import partial as _partial
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from otto_tpu.models.gbdt import _histograms
    from otto_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(2)
    n, f, bins, w = 1024, 4, 8, 2
    bn = rng.integers(0, bins, size=(n, f)).astype(np.uint8)
    node = rng.integers(0, w, size=n).astype(np.int32)
    gh3 = rng.normal(size=(n, 3)).astype(np.float32)

    ctx = make_mesh(jax.devices()[:8], data_parallel=8)
    fn = shard_map(
        _partial(_histograms, n_nodes_w=w, n_bins=bins, row_chunk=64,
                 axis_name="data"),
        mesh=ctx.mesh, in_specs=(P("data"), P("data"), P("data")),
        out_specs=P(), check_vma=False,
    )
    h = np.asarray(jax.jit(fn)(
        jnp.asarray(bn), jnp.asarray(node), jnp.asarray(gh3)
    ))
    ghc = (
        (node[:, None] == np.arange(w))[:, :, None] * gh3[:, None, :]
    ).reshape(n, w * 3)
    for fi in range(f):
        for di in range(w * 3):
            oracle = np.bincount(bn[:, fi], weights=ghc[:, di], minlength=bins)
            np.testing.assert_allclose(h[fi, :, di], oracle, rtol=5e-2, atol=1e-1)


def test_gbdt_chunked_dispatch_bit_identical():
    """trees_per_dispatch chunking (carry scores, global tree ids) must
    reproduce the single-dispatch model exactly — same rng per tree, same
    split decisions."""
    import dataclasses

    x, y, sess = _synthetic_ranking(n_groups=60)
    base = GBDTConfig(
        n_trees=12, max_depth=3, n_bins=16, colsample=0.8, subsample=0.9,
        min_child_samples=5, max_group=16, row_chunk=512, group_chunk=32,
        trees_per_dispatch=12,
    )
    chunked = dataclasses.replace(base, trees_per_dispatch=5)  # 5+5+2
    names = tuple(f"f{i}" for i in range(10))
    m1 = train_gbdt_ranker(x, y, sess, names, base)
    m2 = train_gbdt_ranker(x, y, sess, names, chunked)
    np.testing.assert_array_equal(m1.gfeat, m2.gfeat)
    np.testing.assert_array_equal(m1.thr, m2.thr)
    np.testing.assert_allclose(m1.leaf, m2.leaf, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(m1.predict(x[:64]), m2.predict(x[:64]),
                               rtol=1e-5, atol=1e-6)


def test_device_binning_matches_host():
    import jax.numpy as jnp

    from otto_tpu.models.gbdt import _bin_program

    rng = np.random.default_rng(7)
    x = rng.normal(size=(500, 6)).astype(np.float32)
    x[:, 2] = -1.0
    edges = compute_bin_edges(x, n_bins=16)
    host = bin_features(x, edges)
    dev = np.asarray(_bin_program(jnp.asarray(x), jnp.asarray(edges)))
    np.testing.assert_array_equal(host, dev)


@pytest.mark.parametrize("depth", [3, 4])
def test_predict_binned_matches_numpy_walk(depth):
    """Vectorized all-trees traversal vs a per-row, per-tree NumPy walk."""
    from otto_tpu.models.gbdt import _predict_binned_program, leaf_index_program

    rng = np.random.default_rng(depth)
    M, F, T, B = 300, 7, 11, 16
    W = 1 << (depth - 1)
    bins = rng.integers(0, B, (M, F)).astype(np.uint8)
    gfeat = rng.integers(0, F, (T, depth, W)).astype(np.int32)
    thr = rng.integers(1, B + 1, (T, depth, W)).astype(np.int32)  # B = no-op
    leaf = rng.normal(size=(T, 1 << depth)).astype(np.float32)
    want_node = np.zeros((M, T), np.int64)
    for m in range(M):
        for t in range(T):
            node = 0
            for lvl in range(depth):
                go_right = bins[m, gfeat[t, lvl, node]] >= thr[t, lvl, node]
                node = node * 2 + int(go_right)
            want_node[m, t] = node
    want = leaf[np.arange(T)[None, :], want_node].astype(np.float64).sum(1)
    args = [jnp.asarray(a) for a in (bins, gfeat, thr)]
    np.testing.assert_array_equal(np.asarray(leaf_index_program(*args)),
                                  want_node)
    got = _predict_binned_program(*args, jnp.asarray(leaf), B)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)
