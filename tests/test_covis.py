"""Co-visitation counting vs a NumPy oracle implementing the reference
semantics (reference: model/count_co_events.py:17-77) directly."""
import numpy as np
import jax.numpy as jnp
import pytest

from otto_tpu.config import CoVisConfig
from otto_tpu.data.schema import Events
from otto_tpu.data.synthetic import SyntheticSpec, generate
from otto_tpu.engine.covis import CoVisCounter, build_retrieval_tables
from otto_tpu.ops import counts as counts_ops
from otto_tpu.ops import segment as seg

SENT = int(seg.SENTINEL)


def oracle_counts(ev: Events, cfg: CoVisConfig):
    """Direct per-session double loop replicating the polars self-join."""
    out = {name: {} for name in cfg.names}
    # dedup rows
    rows = sorted(set(zip(ev.session.tolist(), ev.aid.tolist(), ev.ts.tolist(), ev.type.tolist())))
    by_sess = {}
    for s, a, t, ty in rows:
        by_sess.setdefault(s, []).append((a, t, ty))
    for s, evs in by_sess.items():
        for i, (a_i, t_i, ty_i) in enumerate(evs):
            for j, (a_j, t_j, ty_j) in enumerate(evs):
                if i == j:
                    continue
                dt = t_j - t_i
                if dt < cfg.min_time_to_next or dt > cfg.max_time_to_next:
                    continue
                for name, (type_this, types_next) in cfg.count_types.items():
                    if ty_i != type_this or ty_j not in types_next:
                        continue
                    if abs(dt) > cfg.max_time_to_next_by_type[name]:
                        continue
                    key = (a_i, a_j)
                    out[name][key] = out[name].get(key, 0) + 1
    return out


def make_events(n_sessions=300, seed=3):
    spec = SyntheticSpec(
        n_sessions=n_sessions, n_aids=500, max_len=24, mean_len=8, seed=seed
    )
    return generate(spec)


def table_to_dict(t):
    a = np.asarray(t.aid)
    b = np.asarray(t.aid_next)
    c = np.asarray(t.count)
    n = int(t.n)
    return {(int(a[i]), int(b[i])): int(c[i]) for i in range(n)}


def test_covis_counter_matches_oracle():
    ev = make_events()
    cfg = CoVisConfig()
    counter = CoVisCounter(cfg, capacity=1 << 15, pair_budget=1 << 14,
                           bucket_lens=(8, 32))
    counter.update(ev)
    # finalize with min_count=1 to compare raw counts
    got = {
        name: table_to_dict(
            counts_ops.finalize(t, 1, cfg.max_pairs_to_save)
        )
        for name, t in counter.tables.items()
    }
    want = oracle_counts(ev, cfg)
    for name in cfg.names:
        assert got[name] == want[name], f"mismatch for {name}"


def test_covis_counter_chunked_equals_single():
    """Streaming chunks of sessions must equal one-shot counting."""
    ev = make_events(200, seed=5)
    cfg = CoVisConfig()
    one = CoVisCounter(cfg, capacity=1 << 15, bucket_lens=(8, 32))
    one.update(ev)

    two = CoVisCounter(cfg, capacity=1 << 15, bucket_lens=(8, 32))
    mid = ev.session < 100
    two.update(ev.select(mid))
    two.update(ev.select(~mid))

    for name in cfg.names:
        t1 = table_to_dict(counts_ops.finalize(one.tables[name], 1, 10**9))
        t2 = table_to_dict(counts_ops.finalize(two.tables[name], 1, 10**9))
        assert t1 == t2


def test_merge_overflow_keeps_top_counts():
    t = counts_ops.empty_table(4)
    aid = jnp.array([1, 2, 3, 4, 5, 6], jnp.int32)
    nxt = jnp.array([0, 0, 0, 0, 0, 0], jnp.int32)
    cnt = jnp.array([10, 2, 30, 1, 50, 5], jnp.int32)
    t = counts_ops.merge_into(t, aid, nxt, cnt)
    d = table_to_dict(t)
    assert d == {(5, 0): 50, (3, 0): 30, (1, 0): 10, (6, 0): 5}


def test_finalize_min_count():
    t = counts_ops.empty_table(8)
    aid = jnp.array([1, 2, 3], jnp.int32)
    nxt = jnp.array([9, 9, 9], jnp.int32)
    cnt = jnp.array([10, 2, 5], jnp.int32)
    t = counts_ops.merge_into(t, aid, nxt, cnt)
    f = counts_ops.finalize(t, 5, 10**9)
    assert table_to_dict(f) == {(1, 9): 10, (3, 9): 5}


def test_build_retrieval_tables():
    t = counts_ops.empty_table(16)
    #            aid=7 neighbours: 1(c=100), 2(c=50), 3(c=10); aid=8: 4(c=20)
    aid = jnp.array([7, 7, 7, 8], jnp.int32)
    nxt = jnp.array([3, 1, 2, 4], jnp.int32)
    cnt = jnp.array([10, 100, 50, 20], jnp.int32)
    t = counts_ops.merge_into(t, aid, nxt, cnt)
    tabs = build_retrieval_tables(t, n_aids=10, first_n=2)
    nbr = np.asarray(tabs.neighbor)
    assert nbr[7].tolist() == [1, 2]  # top-2 by count, 3 trimmed
    assert nbr[8].tolist() == [4, -1]
    cnt_t = np.asarray(tabs.count)
    assert cnt_t[7].tolist() == [100, 50]
    crel = np.asarray(tabs.count_rel)
    assert crel[7].tolist() == [100, 50]  # 100/100, 50/100
    assert crel[8, 0] == 100
    # count_pop: min=10, q9999 == max=100 (tiny table) -> (100-10)/90*10000
    cpop = np.asarray(tabs.count_pop)
    assert cpop[7, 0] == 10_000


def test_covis_counter_ladder_equals_direct():
    """The log-structured merge ladder must be lossless: exactly the same
    final counts regardless of arity / pair budget / chunking (different
    ladder shapes exercise run merges at several levels + the drain path)."""
    ev = make_events(300, seed=9)
    cfg = CoVisConfig()
    direct = CoVisCounter(cfg, capacity=1 << 15, pair_budget=1 << 14,
                          bucket_lens=(8, 32), arity=2)
    direct.update(ev)
    ref = {
        name: table_to_dict(counts_ops.finalize(t, 1, 10**9))
        for name, t in direct.tables.items()
    }

    laddered = CoVisCounter(cfg, capacity=1 << 15, pair_budget=1 << 12,
                            bucket_lens=(8, 32), arity=4)
    mid = ev.session < 150
    laddered.update(ev.select(mid))
    laddered.update(ev.select(~mid))  # merge boundaries interleave chunks
    assert laddered.n_levels >= 1
    for name in cfg.names:
        t2 = table_to_dict(counts_ops.finalize(laddered.tables[name], 1, 10**9))
        assert ref[name] == t2, f"laddered counting diverged for {name}"

    # reading tables mid-stream (drain) then updating more must stay exact
    resumed = CoVisCounter(cfg, capacity=1 << 15, pair_budget=1 << 12,
                           bucket_lens=(8, 32), arity=4)
    resumed.update(ev.select(mid))
    _ = resumed.tables
    resumed.update(ev.select(~mid))
    for name in cfg.names:
        t3 = table_to_dict(counts_ops.finalize(resumed.tables[name], 1, 10**9))
        assert ref[name] == t3, f"drain-resume counting diverged for {name}"


def test_spill_counter_matches_oracle_past_device_capacity():
    """Reference-capacity semantics: with host
    spill, finalize() must match the NumPy oracle EXACTLY even when the
    unique-pair count exceeds the device accumulator capacity — where the
    bounded-table path is forced into lossy in-part overflow pruning.
    Oracle semantics = global groupby-count + min_count prune + top-N cap
    (reference: model/count_co_events.py:64-72,171-179)."""
    ev = make_events(400, seed=13)
    cfg = CoVisConfig()
    want_raw = oracle_counts(ev, cfg)
    n_uniq = len(want_raw["click_to_click"])
    capacity = 256  # per type — far below the unique pair count
    assert n_uniq > capacity

    spilled = CoVisCounter(cfg, capacity=capacity, pair_budget=1 << 12,
                           bucket_lens=(8, 32), max_run_rows=1 << 14,
                           spill=True)
    spilled.update(ev)
    assert spilled._store.rows_spilled > 0  # the spill path actually ran
    for name in cfg.names:
        t = spilled.tables[name]
        got = table_to_dict(t)
        assert got == want_raw[name], f"spill counts diverged for {name}"

    # finalize applies reference min_count + top-max_pairs semantics
    min_c = cfg.min_count_to_save["click_to_click"]
    fin = spilled.finalize()["click_to_click"]
    want_fin = {k: v for k, v in want_raw["click_to_click"].items()
                if v >= min_c}
    assert table_to_dict(fin) == want_fin

    # the device bounded-table path at this capacity CANNOT hold the counts
    # (documents exactly the divergence the spill mode removes)
    bounded = CoVisCounter(cfg, capacity=capacity, pair_budget=1 << 12,
                           bucket_lens=(8, 32), spill=False)
    bounded.update(ev)
    got_b = table_to_dict(bounded.tables["click_to_click"])
    assert len(got_b) <= capacity < n_uniq


def test_host_run_store_auto_merge_is_exact():
    """Periodic self-compaction (merge_every_rows) must not change the
    global groupby-sum — it only bounds peak host RAM during a
    reference-scale spill (unbounded raw-run accumulation measured at
    ~2 GB/min on the 161M-event run)."""
    rng = np.random.default_rng(5)
    plain = counts_ops.HostRunStore(merge_every_rows=0)
    compacting = counts_ops.HostRunStore(merge_every_rows=64)
    for _ in range(20):
        n = int(rng.integers(10, 40))
        k1 = np.sort(rng.integers(0, 30, n).astype(np.int32))
        k2 = rng.integers(0, 30, n).astype(np.int32)
        # sort by (k1, k2) as real spilled runs are
        order = np.lexsort((k2, k1))
        k1, k2 = k1[order], k2[order]
        cnt = rng.integers(1, 5, n).astype(np.int32)
        plain.add_run(k1, k2, cnt)
        compacting.add_run(k1, k2, cnt)
    assert compacting.n_auto_merges > 0
    a = plain.merged()
    b = compacting.merged()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert plain.rows_spilled == compacting.rows_spilled


@pytest.mark.parametrize("grid", [False, True])
def test_host_topn_tables_match_device(grid):
    """host_topn_tables (spill-mode retrieval-table builder) must reproduce
    build_retrieval_tables bit for bit on the same finalized counts."""
    rng = np.random.default_rng(4)
    n_aids = 50
    if grid:
        # exactly 500 pairs: rank / 500 * 10_000 lands on integers, where
        # float32 and float64 truncations differ
        aid = np.repeat(np.arange(n_aids, dtype=np.int32), 10)
        nxt = np.tile(np.arange(10, dtype=np.int32), n_aids)
    else:
        aid = rng.integers(0, n_aids, 600).astype(np.int32)
        nxt = rng.integers(0, n_aids, 600).astype(np.int32)
        # dedup (host tables are unique by construction)
        key = aid.astype(np.int64) * 64 + nxt
        _, idx = np.unique(key, return_index=True)
        aid, nxt = aid[idx], nxt[idx]
    max_count = 1000
    cnt = rng.integers(1, max_count, len(aid)).astype(np.int32)
    order = np.lexsort((nxt, aid))
    aid, nxt, cnt = aid[order], nxt[order], cnt[order]

    host = counts_ops.host_topn_tables(aid, nxt, cnt, n_aids=n_aids, first_n=5)

    cap = 1 << (len(aid) - 1).bit_length()
    pad = cap - len(aid)
    dev_t = counts_ops.CountTable(
        aid=jnp.asarray(np.pad(aid, (0, pad), constant_values=SENT)),
        aid_next=jnp.asarray(np.pad(nxt, (0, pad), constant_values=SENT)),
        count=jnp.asarray(np.pad(cnt, (0, pad))),
        n=jnp.asarray(len(aid), jnp.int32),
    )
    dev = build_retrieval_tables(dev_t, n_aids=n_aids, first_n=5)
    for name, h, d in zip(
        ("neighbor", "count", "count_pop", "perc_pop", "count_rel"),
        host, dev,
    ):
        np.testing.assert_array_equal(h, np.asarray(d), err_msg=name)


def test_host_finalize_top_pairs_cap():
    aid = np.array([1, 2, 3, 4], np.int32)
    nxt = np.array([0, 0, 0, 0], np.int32)
    cnt = np.array([10, 50, 5, 30], np.int32)
    a, b, c = counts_ops.host_finalize(aid, nxt, cnt, min_count=6, max_pairs=2)
    assert a.tolist() == [2, 4] and c.tolist() == [50, 30]


def test_merge_runs_compact_raw_matches_general():
    """The keys-only raw-run merge must equal the payload-carrying one on
    unit-count runs (the exact shape _emit_run_step produces)."""
    rng = np.random.default_rng(11)
    runs = []
    for _ in range(4):
        m = rng.random(256) < 0.6
        k1 = np.where(m, rng.integers(0, 40, 256), SENT).astype(np.int32)
        k2 = np.where(m, rng.integers(0, 40, 256), SENT).astype(np.int32)
        runs.append(counts_ops.CountTable(
            aid=jnp.asarray(k1),
            aid_next=jnp.asarray(k2),
            count=jnp.asarray(m.astype(np.int32)),
            n=jnp.asarray(m.sum(), jnp.int32),
        ))
    ref = counts_ops.merge_runs_compact(tuple(runs))
    raw = counts_ops.merge_runs_compact_raw(tuple(runs))
    assert int(ref.n) == int(raw.n)
    np.testing.assert_array_equal(np.asarray(ref.aid), np.asarray(raw.aid))
    np.testing.assert_array_equal(
        np.asarray(ref.aid_next), np.asarray(raw.aid_next))
    np.testing.assert_array_equal(np.asarray(ref.count), np.asarray(raw.count))


def test_prune_tagged_drops_below_in_part_min():
    """Spill-time in-part pruning (reference MIN_COUNT_IN_PART semantics,
    reference: model/count_co_events.py:131-133, config.py:63): rows below
    their type's threshold drop; other tags keep everything; result stays
    front-compacted in key order."""
    stride = 1000
    # tag 0 threshold 2, tag 1 threshold 1 (keep all)
    aid = np.array([0 * stride + 3, 0 * stride + 7, 1 * stride + 2,
                    1 * stride + 9, SENT], np.int32)
    aid_next = np.array([5, 6, 7, 8, SENT], np.int32)
    count = np.array([1, 4, 1, 2, 0], np.int32)
    t = counts_ops.CountTable(
        jnp.asarray(aid), jnp.asarray(aid_next), jnp.asarray(count),
        jnp.int32(4),
    )
    got = counts_ops.prune_tagged(t, (2, 1), stride)
    assert int(got.n) == 3
    d = table_to_dict(got)
    assert d == {(7, 6): 4, (1 * stride + 2, 7): 1, (1 * stride + 9, 8): 2}
    # key order, sentinels at the back
    a = np.asarray(got.aid)
    assert a[3] == SENT and a[4] == SENT
    assert np.all(np.diff(a[:3]) > 0)


def test_spill_prune_matches_reference_in_part_semantics():
    """End-to-end: a spill counter with pruning enabled must equal the
    lossless counter AFTER the per-type in-part filter is applied to each
    spilled window — here a single window covers everything, so pruned
    == {pairs with count >= min_in_part[type]} exactly."""
    ev = make_events(250, seed=11)
    cfg = CoVisConfig()
    lossless = CoVisCounter(cfg, capacity=1 << 15, pair_budget=1 << 14,
                            bucket_lens=(8, 32), spill=True)
    lossless.update(ev)
    # prune threshold 1 row => every spilled run is pruned
    import dataclasses as _dc
    cfg_p = _dc.replace(cfg, spill_prune_min_rows=1)
    pruned = CoVisCounter(cfg_p, capacity=1 << 15, pair_budget=1 << 14,
                          bucket_lens=(8, 32), spill=True)
    pruned.update(ev)
    # same (single-window) spill granularity: drain both fully first
    t_l = {n: table_to_dict(t) for n, t in lossless.tables.items()}
    t_p = {n: table_to_dict(t) for n, t in pruned.tables.items()}
    assert pruned._ladder.rows_pruned > 0
    minp = {n: max(1, cfg.min_count_in_part.get(n, 1)) for n in cfg.names}
    for name in cfg.names:
        if minp[name] == 1:
            # types without an in-part threshold must be untouched
            assert t_p[name] == t_l[name]
            continue
        # pruned counts can only shrink (window sub-counts were dropped),
        # and a pruned pair's lost mass is < threshold per spilled window
        for k, v in t_p[name].items():
            assert t_l[name][k] >= v
        # heavy pairs always survive: at count >= 64 over the handful of
        # spilled windows here, some window holds >= the threshold (2)
        heavy = {k for k, v in t_l[name].items() if v >= 64}
        assert heavy <= set(t_p[name])
