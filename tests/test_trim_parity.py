"""Recency-adaptive trim parity vs a hand-computed reference keep set
(reference: model/retrieve.py:490-510): bound the trim semantics.

The reference keeps a (source-aid, candidate) pair iff
    aid == aid_next
  | min(per-count-type rank) <= th(best order of the source aid)
  | min(w2vec ranks)         <= th(...)
With trim_max_at_order_1 == trim_min the threshold is CONSTANT, which
isolates the filter semantics (min across type ranks, self bypass, w2v
bypass, union across sources) from order-stat tie-breaking."""
import numpy as np
import jax.numpy as jnp

from otto_tpu.config import RetrievalConfig
from otto_tpu.data.schema import Events
from otto_tpu.engine.covis import CoVisTables
from otto_tpu.engine.retrieval import (
    RetrievalContext,
    Retriever,
    SessionLookup,
)

N_AIDS = 64
D = 4


def covis_from_rows(rows, n_top):
    """rows: {aid: [(aid_next, count), ...]} sorted by count desc."""
    nbr = np.full((N_AIDS, n_top), -1, np.int32)
    cnt = np.zeros((N_AIDS, n_top), np.int32)
    for a, lst in rows.items():
        for j, (b, c) in enumerate(lst):
            nbr[a, j], cnt[a, j] = b, c
    return CoVisTables(*(jnp.asarray(x) for x in (nbr, cnt, cnt, cnt, cnt)))


def test_trim_matches_reference_keep_set():
    # source aid 1: c2c candidates at ranks 1..6 (aids 10..15)
    c2c = covis_from_rows({1: [(10 + i, 60 - i) for i in range(6)]}, 8)
    # cart_to_cart gives aid 13 (rank 4 in c2c) rank 1 -> min rank 1 keeps it
    ctc = covis_from_rows({1: [(13, 99)]}, 8)
    empty = covis_from_rows({}, 8)
    covis = (c2c, empty, ctc, empty, empty)

    # w2v_all for aid 1: aids 20, 21, 22 at ranks 1, 2, 3
    knn_nbr = np.full((N_AIDS, 4), -1, np.int32)
    knn_dist = np.zeros((N_AIDS, 4), np.float32)
    knn_nbr[1] = [20, 21, 22, -1]
    knn_dist[1] = [0.1, 0.2, 0.3, 0.0]
    knn_12 = (jnp.asarray(np.full((N_AIDS, 4), -1, np.int32)),
              jnp.asarray(np.zeros((N_AIDS, 4), np.float32)))

    ctx = RetrievalContext(
        covis=covis,
        knn_all=(jnp.asarray(knn_nbr), jnp.asarray(knn_dist)),
        knn_1_2=knn_12,
        pop_cl50_cand=jnp.asarray(np.full((2, 4), -1, np.int32)),
        pop_cl50_ranks=jnp.asarray(np.full((2, 4, 6), 999, np.int32)),
        pop_cl1_rank=jnp.asarray(np.full((N_AIDS, 6), 999, np.int32)),
        aid_emb=jnp.asarray(np.zeros((N_AIDS, D), np.float32)),
    )

    # session: single aid 1 (a cart event so cart_to_cart fans out too)
    test = Events(
        session=np.array([7, 7], np.int32),
        aid=np.array([1, 1], np.int32),
        ts=np.array([1000, 2000], np.int32),
        type=np.array([0, 1], np.int8),
    )
    # constant threshold th = 2 everywhere
    cfg = RetrievalConfig(
        max_session_aids=8, max_candidates=16, session_len_buckets=(8,),
        trim_max_at_order_1=2, trim_min=2, trim_min_at_order=20,
    )
    r = Retriever(
        ctx=ctx, cfg=cfg,
        sessions=SessionLookup.from_dicts(
            {7: 0}, {7: np.zeros(D, np.float32)}, D
        ),
    )
    b = r.run(test, batch_sessions=1)[0]
    got = set(b.cand[0][b.cand[0] >= 0].tolist())

    # reference keep set at th=2:
    #   self: 1
    #   c2c ranks 1, 2 -> aids 10, 11; ranks 3..6 trimmed (12, 14, 15)
    #   aid 13: c2c rank 4 BUT cart_to_cart rank 1 -> min rank 1 -> kept
    #   w2v ranks 1, 2 -> aids 20, 21; rank 3 (22) trimmed
    assert got == {1, 10, 11, 13, 20, 21}, got


def _reference_trim_oracle(sources, max_at_1, min_n, min_at_order):
    """NumPy oracle of the reference's recency-adaptive trim
    (reference: model/retrieve.py:490-510):
        th(o)  = max(min_n, max_at_1 - delta * (o - 1)),
        delta  = (max_at_1 - min_n) / (min_at_order - 1)
        keep (s, c) iff c == s | best_co_rank <= th | best_w2v_rank <= th
    `sources`: list of (src_aid, best_order, [(cand, co_rank, w2v_rank)]).
    Returns the union keep set (the engine dedups candidates at level 2)."""
    delta = (max_at_1 - min_n) / (min_at_order - 1)
    keep = set()
    for src, order, cands in sources:
        th = max(min_n, max_at_1 - delta * (order - 1.0))
        keep.add(src)  # self candidate always survives
        for cand, co_rank, w2v_rank in cands:
            if (cand == src) or (co_rank <= th) or (w2v_rank <= th):
                keep.add(cand)
    return keep


def test_trim_adaptive_threshold_matches_oracle():
    """The NON-constant case: per-source-aid threshold
    falls with the aid's best order (recency/frequency rank) and clips at
    trim_min. Session aids 1..4 get best orders 1..4 (both rank_by_n_aid
    and ts_order_aid agree by construction); with max_at_1=6, min=1,
    min_at_order=3 (delta=2.5) the thresholds are 6, 3.5, 1, 1 — so each
    source keeps a different number of ranked candidates, and order 4
    exercises the clip."""
    INF = 10 ** 6
    # c2c: source aid a -> 8 candidates (10*a + j) at ranks 1..8
    c2c = covis_from_rows(
        {a: [(10 * a + j, 80 - j) for j in range(8)] for a in (1, 2, 3, 4)},
        8,
    )
    empty = covis_from_rows({}, 8)
    covis = (c2c, empty, empty, empty, empty)

    # w2v_all: aid 1 -> cand 50 at rank 5 (kept, th=6);
    #          aid 3 -> cand 52 rank 1 (kept), cand 51 rank 2 (trimmed, th=1)
    knn_nbr = np.full((N_AIDS, 8), -1, np.int32)
    knn_dist = np.zeros((N_AIDS, 8), np.float32)
    knn_nbr[1, 4] = 50
    knn_dist[1] = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8]
    knn_nbr[3, :2] = [52, 51]
    knn_dist[3] = knn_dist[1]
    knn_12 = (jnp.asarray(np.full((N_AIDS, 8), -1, np.int32)),
              jnp.asarray(np.zeros((N_AIDS, 8), np.float32)))

    ctx = RetrievalContext(
        covis=covis,
        knn_all=(jnp.asarray(knn_nbr), jnp.asarray(knn_dist)),
        knn_1_2=knn_12,
        pop_cl50_cand=jnp.asarray(np.full((2, 4), -1, np.int32)),
        pop_cl50_ranks=jnp.asarray(np.full((2, 4, 6), 999, np.int32)),
        pop_cl1_rank=jnp.asarray(np.full((N_AIDS, 6), 999, np.int32)),
        aid_emb=jnp.asarray(np.zeros((N_AIDS, D), np.float32)),
    )

    # session: aid 4 x1 (oldest), aid 3 x2, aid 2 x3, aid 1 x4 (newest) —
    # ts_order_aid AND rank_by_n_aid both give best_order 1,2,3,4
    aids = [4] + [3] * 2 + [2] * 3 + [1] * 4
    test = Events(
        session=np.full(len(aids), 7, np.int32),
        aid=np.array(aids, np.int32),
        ts=(np.arange(len(aids), dtype=np.int32) * 100 + 1000),
        type=np.zeros(len(aids), np.int8),
    )
    cfg = RetrievalConfig(
        max_session_aids=8, max_candidates=32, session_len_buckets=(16,),
        trim_max_at_order_1=6, trim_min=1, trim_min_at_order=3,
    )
    r = Retriever(
        ctx=ctx, cfg=cfg,
        sessions=SessionLookup.from_dicts(
            {7: 0}, {7: np.zeros(D, np.float32)}, D
        ),
    )
    b = r.run(test, batch_sessions=1)[0]
    got = set(b.cand[0][b.cand[0] >= 0].tolist())

    sources = []
    for a, order in [(1, 1), (2, 2), (3, 3), (4, 4)]:
        cands = [(10 * a + j, j + 1, INF) for j in range(8)]
        if a == 1:
            cands.append((50, INF, 5))
        if a == 3:
            cands += [(52, INF, 1), (51, INF, 2)]
        sources.append((a, order, cands))
    want = _reference_trim_oracle(sources, 6.0, 1.0, 3)
    # hand check: th = 6 / 3.5 / 1 / 1 ->
    #   src 1 keeps c2c ranks 1-6 (10..15) + w2v 50; src 2 ranks 1-3
    #   (20..22); src 3 rank 1 (30) + w2v 52; src 4 rank 1 (40); selves 1-4
    assert want == {1, 2, 3, 4, 10, 11, 12, 13, 14, 15,
                    20, 21, 22, 30, 40, 50, 52}
    assert got == want, (sorted(got), sorted(want))
