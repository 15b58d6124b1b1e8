"""Cluster-popularity counting (C12).

Per (cluster, aid): counts of clicks/carts/orders, all-time and last-7-days;
ordinal ranks within cluster (desc, clipped to 999); keep aids whose best
rank <= keep_top_k (reference: model/count_popularity.py:56-85). The pseudo
clustering cl1 (all sessions in one cluster — general popularity,
reference :39-41) is the n_clusters=1 case.

Device shape: events stream through fixed-size microbatches; each event
emits up to two tagged count lanes (kind = type for all-time, type+3 when
inside the 7-day window) with key (kind * n_clusters + cluster, aid) into
the same CountLadder the co-vis counter uses (engine/covis.py). Rank and
dense-table building happen host-side over the merged uniques.

Why not one whole-dataset program: the previous design padded the full
event axis to a power of two and sorted it in a single jit — at 16M+
events the compile alone took tens of minutes and the program shape
changed with every dataset size. The ladder path compiles
ONE small fixed-shape emit program, reused for every microbatch and every
dataset.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from otto_tpu.config import PopularityConfig
from otto_tpu.data.schema import Events
from otto_tpu.ops import segment as seg
from otto_tpu.ops.counts import CountTable

N_COUNTS = 6  # clicks, carts, orders, clicks_7d, carts_7d, orders_7d
COUNT_NAMES = ("clicks", "carts", "orders", "clicks_7d", "carts_7d", "orders_7d")


class PopularityTables(NamedTuple):
    """Dense cluster-popularity candidate tables.

    candidate [C, T] int32: aids whose best rank <= keep_top_k, -1 pad.
    ranks     [C, T, 6] int32: the six rank columns (clip 999), aligned with
              candidate (reference output columns rank_{kind}_cl{n},
              model/count_popularity.py:73-77).
    aid_rank  [A, 6] int32: rank lookup for ALL aids (for joining general-
              popularity rank features without adding candidates,
              reference: model/retrieve.py:588-590). 999 when absent.
    """

    candidate: np.ndarray
    ranks: np.ndarray
    aid_rank: np.ndarray


def _pop_emit_impl(cluster, aid, type_, ts, ts_7d, n_clusters: int) -> CountTable:
    """One microbatch -> raw tagged count run (2 lanes/event: all-time kind
    and, when ts > ts_7d, the recent kind). Padded lanes carry aid == -1."""
    valid = aid >= 0
    k1a = type_.astype(jnp.int32) * n_clusters + cluster
    recent = valid & (ts > ts_7d)
    k1 = jnp.concatenate([
        jnp.where(valid, k1a, seg.SENTINEL),
        jnp.where(recent, k1a + 3 * n_clusters, seg.SENTINEL),
    ])
    k2 = jnp.concatenate([
        jnp.where(valid, aid, seg.SENTINEL),
        jnp.where(recent, aid, seg.SENTINEL),
    ])
    cnt = jnp.concatenate([valid, recent]).astype(jnp.int32)
    n = (jnp.sum(valid) + jnp.sum(recent)).astype(jnp.int32)
    return CountTable(k1, k2, cnt, n)


_pop_emit = partial(jax.jit, static_argnums=(5,))(_pop_emit_impl)


def make_sharded_pop_emit(mesh_ctx, n_clusters: int):
    """Sharded popularity counting step: events shard over the data axis;
    each device emits its tagged lanes and LOCALLY sort-compresses them
    (map-side combine). Output: per-shard compacted runs stacked on a
    leading shard axis — the host driver pushes each as a compacted ladder
    run, so the existing merge machinery gives bit-identical global counts
    for any mesh size (the SPMD form of the reference's chunked count +
    merge, model/count_popularity.py:56-70 via count_co_events-style
    aggregation)."""
    import jax.experimental  # noqa: F401  (shard_map import path)
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from otto_tpu.ops import segment as _seg

    axis = mesh_ctx.data_axis

    def per_shard(cluster, aid, type_, ts, ts_7d):
        t = _pop_emit_impl(cluster, aid, type_, ts, ts_7d, n_clusters)
        ua, ub, uc, nu = _seg.sort_compress(t.aid, t.aid_next, t.count)
        return CountTable(
            ua[None], ub[None], uc[None], nu.reshape(1)
        )

    out_specs = CountTable(
        aid=P(axis, None), aid_next=P(axis, None),
        count=P(axis, None), n=P(axis),
    )
    fn = shard_map(
        per_shard, mesh=mesh_ctx.mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=out_specs, check_vma=False,
    )
    return jax.jit(fn)


def _segment_starts(sorted_keys: np.ndarray) -> np.ndarray:
    first = np.empty(len(sorted_keys), bool)
    first[0] = True
    np.not_equal(sorted_keys[1:], sorted_keys[:-1], out=first[1:])
    return np.flatnonzero(first)


def _host_pop_tables(
    k1: np.ndarray, k2: np.ndarray, cnt: np.ndarray,
    n_clusters: int, n_aids: int, top_slots: int,
    keep_top_k: int, rank_clip: int,
) -> PopularityTables:
    """Merged tagged counts -> ranks -> dense candidate/rank tables
    (reference semantics: model/count_popularity.py:61-85)."""
    cand = np.full((n_clusters, top_slots), -1, np.int32)
    rank_t = np.full((n_clusters, top_slots, N_COUNTS), rank_clip, np.int32)
    aid_rank = np.full((n_aids, N_COUNTS), rank_clip, np.int32)
    if len(k1) == 0:
        return PopularityTables(cand, rank_t, aid_rank)

    kind = k1 // n_clusters
    cluster = k1 - kind * n_clusters
    ckey = cluster.astype(np.int64) * n_aids + k2
    # per-kind slices of the merged stream are already (cluster, aid)-sorted,
    # so a stable argsort is a near-linear 6-way run merge (timsort)
    order = np.argsort(ckey, kind="stable")
    ck_s = ckey[order]
    starts = _segment_starts(ck_s)
    group = np.zeros(len(ck_s), np.int64)
    group[starts] = 1
    group = np.cumsum(group) - 1
    U = len(starts)
    counts = np.zeros((U, N_COUNTS), np.int64)
    counts[group, kind[order]] = cnt[order]
    uk = ck_s[starts]
    ucl = (uk // n_aids).astype(np.int32)
    uaid = (uk - ucl.astype(np.int64) * n_aids).astype(np.int32)

    # per-cluster ordinal ranks, count desc (ucl is ascending already)
    ranks = np.empty((U, N_COUNTS), np.int32)
    pos = np.arange(U, dtype=np.int64)
    for j in range(N_COUNTS):
        o = np.lexsort((-counts[:, j], ucl))
        cl_s = ucl[o]
        st = _segment_starts(cl_s)
        start_of = np.repeat(st, np.diff(np.append(st, U)))
        ranks[o, j] = np.minimum(pos - start_of + 1, rank_clip)

    best = ranks.min(axis=1)
    keep = np.flatnonzero(best <= keep_top_k)
    o = keep[np.lexsort((best[keep], ucl[keep]))]
    cl_s = ucl[o]
    if len(cl_s):
        st = _segment_starts(cl_s)
        start_of = np.repeat(st, np.diff(np.append(st, len(cl_s))))
        slot = np.arange(len(cl_s)) - start_of
        ok = slot < top_slots
        cand[cl_s[ok], slot[ok]] = uaid[o][ok]
        rank_t[cl_s[ok], slot[ok]] = ranks[o][ok]
    aid_rank[uaid] = ranks
    return PopularityTables(cand, rank_t, aid_rank)


def compute_popularity(
    events: Events,
    session_cluster: np.ndarray,  # cluster id per event's session, int32
    n_clusters: int,
    n_aids: int,
    cfg: PopularityConfig,
    top_slots: int = 128,
    event_budget: int = 1 << 22,
    mesh_ctx=None,
) -> PopularityTables:
    """Host driver. `session_cluster` is per-EVENT cluster assignment
    (gather cluster-of-session on host before the call). With `mesh_ctx`,
    events shard over the data axis and each device locally combines its
    lanes before the global ladder merge (make_sharded_pop_emit)."""
    from otto_tpu.engine.covis import CountLadder

    n = len(events.aid)
    ts_max = int(events.ts.max()) if n else 0
    ts_7d = ts_max - cfg.recent_window

    n_dev = 1
    emit_sharded = None
    if mesh_ctx is not None and mesh_ctx.n_devices > 1:
        n_dev = mesh_ctx.mesh.shape[mesh_ctx.data_axis]
        emit_sharded = make_sharded_pop_emit(mesh_ctx, n_clusters)

    # fixed microbatch of P events (pad tail with aid == -1): one compiled
    # emit program per (P, n_clusters) for the whole run
    P = min(event_budget, max(8, 1 << (n - 1).bit_length()) if n else 8)
    P = -(-P // n_dev) * n_dev
    ladder = CountLadder(
        run_size=2 * P // n_dev,
        top_capacity=8,
        min_in_part=(1,) * N_COUNTS,
        stride=n_clusters,
        spill=True,
    )
    cl = np.ascontiguousarray(session_cluster, np.int32)
    for lo in range(0, max(n, 1), P):
        hi = min(lo + P, n)
        pad = P - (hi - lo)

        def _p(x, fill):
            x = np.asarray(x[lo:hi], np.int32)
            return np.pad(x, (0, pad), constant_values=fill) if pad else x

        args = (
            jnp.asarray(_p(cl, 0)),
            jnp.asarray(_p(events.aid, -1)),
            jnp.asarray(_p(events.type, 0)),
            jnp.asarray(_p(events.ts, 0)),
            jnp.int32(ts_7d),
        )
        if emit_sharded is not None:
            stacked = emit_sharded(*args)
            for i in range(n_dev):
                ladder.push_compacted(CountTable(
                    stacked.aid[i], stacked.aid_next[i],
                    stacked.count[i], stacked.n[i],
                ))
        else:
            ladder.push(_pop_emit(*args, n_clusters))
    k1, k2, cnt = ladder.host_merged()
    return _host_pop_tables(
        k1, k2, cnt, n_clusters, n_aids, top_slots,
        cfg.keep_top_k, cfg.rank_clip,
    )
