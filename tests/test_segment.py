"""Unit tests for sort-based segment ops against NumPy oracles."""
import numpy as np
import jax.numpy as jnp
import pytest

from otto_tpu.ops import segment as seg

RNG = np.random.default_rng(0)
SENT = int(seg.SENTINEL)


def np_groupby_sum(k1, k2, v):
    out = {}
    for a, b, c in zip(k1, k2, v):
        out[(a, b)] = out.get((a, b), 0) + c
    keys = sorted(out)
    return keys, [out[k] for k in keys]


def test_sort_compress_matches_numpy():
    n = 257
    k1 = RNG.integers(0, 13, n).astype(np.int32)
    k2 = RNG.integers(0, 7, n).astype(np.int32)
    v = RNG.integers(1, 5, n).astype(np.int32)
    valid = RNG.random(n) > 0.2

    uk1, uk2, uv, nu = seg.sort_compress(
        jnp.array(k1), jnp.array(k2), jnp.array(v), jnp.array(valid)
    )
    uk1, uk2, uv, nu = map(np.asarray, (uk1, uk2, uv, int(nu)))

    ref_keys, ref_vals = np_groupby_sum(k1[valid], k2[valid], v[valid])
    assert nu == len(ref_keys)
    got = list(zip(uk1[:nu].tolist(), uk2[:nu].tolist()))
    assert got == ref_keys
    assert uv[:nu].tolist() == ref_vals
    # padding is clean
    assert np.all(uk1[nu:] == SENT)
    assert np.all(uv[nu:] == 0)


def test_sort_compress_all_invalid():
    n = 16
    k = jnp.zeros(n, jnp.int32)
    v = jnp.ones(n, jnp.int32)
    valid = jnp.zeros(n, bool)
    uk1, uk2, uv, nu = seg.sort_compress(k, k, v, valid)
    assert int(nu) == 0
    assert np.all(np.asarray(uv) == 0)


def np_ordinal_rank_desc(group, value, valid):
    """polars rank('ordinal', reverse=True).over(group): ties by input order."""
    n = len(group)
    rank = np.full(n, SENT, np.int64)
    for g in set(group[valid]):
        idx = [i for i in range(n) if valid[i] and group[i] == g]
        order = sorted(idx, key=lambda i: (-value[i], i))
        for r, i in enumerate(order, start=1):
            rank[i] = r
    return rank


def test_ordinal_rank_desc():
    n = 101
    g = RNG.integers(0, 9, n).astype(np.int32)
    v = RNG.integers(0, 4, n).astype(np.int32)  # many ties
    valid = RNG.random(n) > 0.15
    rank = np.asarray(
        seg.ordinal_rank_desc(jnp.array(g), jnp.array(v), jnp.array(valid))
    )
    assert rank.tolist() == np_ordinal_rank_desc(g, v, valid).tolist()


def test_build_topn_tables():
    # aid 0 has neighbours 5(c=9), 6(c=4), 7(c=1); aid 2 has 8(c=3)
    key = jnp.array([0, 0, 0, 2, SENT], jnp.int32)
    nbr = jnp.array([7, 5, 6, 8, 0], jnp.int32)
    cnt = jnp.array([1, 9, 4, 3, 0], jnp.int32)
    nb_t, (cnt_t,) = seg.build_topn_tables(key, nbr, (cnt,), n_keys=3, n_top=2)
    nb_t, cnt_t = np.asarray(nb_t), np.asarray(cnt_t)
    assert nb_t[0].tolist() == [5, 6]  # top-2 by count, 7 dropped
    assert cnt_t[0].tolist() == [9, 4]
    assert nb_t[2].tolist() == [8, -1]
    assert nb_t[1].tolist() == [-1, -1]


def test_rowwise_unique_sum():
    key = jnp.array(
        [[3, 1, 3, SENT], [2, 2, 2, 2]], jnp.int32
    )
    v = jnp.array([[1, 10, 2, 99], [1, 1, 1, 1]], jnp.int32)
    uk, (uv,), nu = seg.rowwise_unique_sum(key, (v,))
    uk, uv, nu = map(np.asarray, (uk, uv, nu))
    assert nu.tolist() == [2, 1]
    assert uk[0, :2].tolist() == [1, 3] and uv[0, :2].tolist() == [10, 3]
    assert uk[1, 0] == 2 and uv[1, 0] == 4
    assert np.all(uk[0, 2:] == SENT) and np.all(uv[0, 2:] == 0)


def test_rowwise_segment_reduce_min_max():
    key = jnp.array([[5, 5, 9, SENT]], jnp.int32)
    vmax = jnp.array([[3, 7, 2, 0]], jnp.int32)
    vmin = jnp.array([[3, 7, 2, 0]], jnp.int32)
    uk, (omax, omin), nu = seg.rowwise_segment_reduce(
        key, (vmax, vmin), ("max", "min")
    )
    assert int(nu[0]) == 2
    assert np.asarray(omax)[0, :2].tolist() == [7, 2]
    assert np.asarray(omin)[0, :2].tolist() == [3, 2]


def test_rowwise_rank_desc():
    v = jnp.array([[5, 9, 9, 1]], jnp.int32)
    valid = jnp.array([[True, True, True, False]])
    rank = np.asarray(seg.rowwise_rank_desc(v, valid))
    assert rank[0].tolist() == [3, 1, 2, SENT]


def test_rowwise_rank_asc():
    v = jnp.array([[5, 9, 2, 1]], jnp.int32)
    valid = jnp.array([[True, True, True, False]])
    rank = np.asarray(seg.rowwise_rank_asc(v, valid))
    assert rank[0].tolist() == [2, 3, 1, SENT]


def test_ordinal_rank_asc_flat():
    g = jnp.array([0, 0, 0, 1], jnp.int32)
    v = jnp.array([30, 10, 20, 5], jnp.int32)
    valid = jnp.ones(4, bool)
    rank = np.asarray(seg.ordinal_rank_asc(g, v, valid))
    assert rank.tolist() == [3, 1, 2, 1]


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.int8])
@pytest.mark.parametrize("C", [100, 300])
def test_rowwise_transport_sort_matches_stable_argsort(dtype, C):
    rng = np.random.default_rng(C)
    S = 6
    key = rng.integers(0, 12, (S, C)).astype(np.int32)
    key[rng.random((S, C)) < 0.2] = SENT
    a = rng.integers(-100, 100, (S, C)).astype(dtype)
    b = np.arange(S * C, dtype=np.int32).reshape(S, C)
    ks, (sa, sb) = seg.rowwise_transport_sort(
        jnp.asarray(key), [jnp.asarray(a), jnp.asarray(b)])
    perm = np.argsort(key, axis=1, kind="stable")
    np.testing.assert_array_equal(np.asarray(ks),
                                  np.take_along_axis(key, perm, 1))
    np.testing.assert_array_equal(np.asarray(sa), np.take_along_axis(a, perm, 1))
    np.testing.assert_array_equal(np.asarray(sb), np.take_along_axis(b, perm, 1))
    assert np.asarray(sa).dtype == dtype


def _np_segment_reduce(ks, v, red):
    """Per row: each segment's reduction at its last lane."""
    fn = {"sum": np.add, "min": np.minimum, "max": np.maximum}[red]
    out = np.zeros_like(v)
    for s in range(ks.shape[0]):
        starts = np.flatnonzero(np.r_[True, ks[s, 1:] != ks[s, :-1]])
        ends = np.r_[starts[1:] - 1, ks.shape[1] - 1]
        out[s, ends] = fn.reduceat(v[s], starts)
    return out


@pytest.mark.parametrize("red", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_rowwise_groupby_scan_matches_numpy(red, dtype):
    rng = np.random.default_rng(7)
    S, C = 5, 260
    key = rng.integers(0, 30, (S, C)).astype(np.int32)
    key[rng.random((S, C)) < 0.1] = SENT
    # float values are multiples of 1/8: sums are exact in any order
    v = (rng.integers(-400, 400, (S, C)) / (8 if dtype == np.float32 else 1)
         ).astype(dtype)
    ks, out, is_end, n_unique = seg.rowwise_groupby_scan(
        jnp.asarray(key), {"v": (jnp.asarray(v), red)})
    perm = np.argsort(key, axis=1, kind="stable")
    ks_ref = np.take_along_axis(key, perm, 1)
    want = _np_segment_reduce(ks_ref, np.take_along_axis(v, perm, 1), red)
    end = np.asarray(is_end)
    np.testing.assert_array_equal(np.asarray(ks), ks_ref)
    np.testing.assert_array_equal(np.asarray(out["v"])[end], want[end])
    # segment ends: last lane of each valid-key segment
    last = np.concatenate(
        [ks_ref[:, 1:] != ks_ref[:, :-1], np.ones((S, 1), bool)], axis=1)
    np.testing.assert_array_equal(end, last & (ks_ref != SENT))
    np.testing.assert_array_equal(
        np.asarray(n_unique),
        [len(np.unique(r[r != SENT])) for r in key])


@pytest.mark.parametrize("red", ["sum", "min", "max"])
def test_segmented_scan_flat_matches_numpy(red):
    rng = np.random.default_rng(3)
    n = 333
    v = rng.integers(-50, 50, n).astype(np.int32)
    first = rng.random(n) < 0.1
    first[0] = True
    (got,) = seg.segmented_scan((jnp.asarray(v),), (red,),
                                jnp.asarray(first), axis=0)
    fn = {"sum": np.add, "min": np.minimum, "max": np.maximum}[red]
    want = np.empty_like(v)
    for s, e in zip(np.flatnonzero(first), np.r_[np.flatnonzero(first)[1:], n]):
        want[s:e] = fn.accumulate(v[s:e])
    np.testing.assert_array_equal(np.asarray(got), want)


def test_rowwise_groupby_scan_layout():
    """rowwise_groupby_scan's segment-end values must equal the compacted
    rowwise_groupby reductions (same groups, different layout)."""
    rng = np.random.default_rng(11)
    S, C = 4, 600
    key = jnp.asarray(rng.integers(0, 40, (S, C)).astype(np.int32))
    cols = {
        "a": (jnp.asarray(rng.integers(0, 100, (S, C)).astype(np.int32)), "sum"),
        "b": (jnp.asarray(rng.integers(0, 100, (S, C)).astype(np.int32)), "min"),
        "c": (jnp.asarray(rng.normal(size=(S, C)).astype(np.float32)), "max"),
    }
    uk, out, n = seg.rowwise_groupby(key, cols)
    ks, scanned, is_end, n2 = seg.rowwise_groupby_scan(key, cols)
    np.testing.assert_array_equal(np.asarray(n), np.asarray(n2))
    ksn = np.asarray(ks); endn = np.asarray(is_end)
    ukn = np.asarray(uk)
    for s in range(S):
        ends = np.nonzero(endn[s])[0]
        np.testing.assert_array_equal(ksn[s, ends], ukn[s, : len(ends)])
        for name in cols:
            vals = np.asarray(scanned[name])[s, ends]
            np.testing.assert_allclose(
                vals, np.asarray(out[name])[s, : len(ends)], rtol=1e-6
            )
