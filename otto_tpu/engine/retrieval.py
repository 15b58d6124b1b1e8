"""Multi-source candidate retrieval + feature generation (C13).

The device re-design of the reference's largest component
(reference: model/retrieve.py:422-657 retrieve_and_gen_feats): instead of
DataFrame joins over (session, aid, aid_next) rows, candidates live on a
dense grid:

  Stage A  per-session / per-session-aid stats          [S, A_k]
  Stage B  source fan-out: for every kept session aid gather its top-N
           lists from the dense co-visit / w2vec tables; append the
           session-cluster popularity list               [S, P] raw entries
  Stage C  level-1 dedup by (session-aid, candidate) — joins the per-pair
           features across sources (reference :480-488), then the
           recency-adaptive trim (reference :490-510)
  Stage D  level-2 groupby candidate — the keep_sessions_aids_next
           aggregation catalogue (reference :293-403)
  Stage E  compaction to C_max candidates + derived/session/popularity/
           similarity features + null-fill conventions (reference :522-625)

Output: candidate ids + a [S, C, F] feature tensor with a canonical
feature-name list (the ranker's input contract, analogous to the parquet
column contract in reference: model/train_lgbm_rankers.py:38-40).

Known deviation (documented): the reference's slf_* min/max aggregates
multiply by (aid == aid_next) BEFORE reducing over the group
(reference :309-334), which zeroes them whenever any non-self pair exists in
the group — we instead propagate the true self value (0/NULL when the
candidate is not a session aid), which is strictly more informative and
internally consistent for our ranker.
"""
from __future__ import annotations

import dataclasses
import logging
from functools import partial
from typing import Dict, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from otto_tpu.config import Config, RetrievalConfig
from otto_tpu.data.batching import PaddedSessions, iter_microbatches, pack_sessions
from otto_tpu.data.schema import Events, Labels
from otto_tpu.engine.covis import CoVisTables
from otto_tpu.engine.popularity import PopularityTables

log = logging.getLogger(__name__)
from otto_tpu.engine.session_embed import KnnTables
from otto_tpu.engine.session_stats import (
    SessionAids,
    compute_session_aids,
    compute_session_stats,
)
from otto_tpu.ops import segment as seg

SENT = seg.SENTINEL
NEG_SENT = seg.NEG_SENTINEL
NULL = -1
AID_BITS = 21  # aids < 2^21 (1.8M items, reference README.md:12)
AID_MASK = (1 << AID_BITS) - 1

COVIS_NAMES = (
    "click_to_click",
    "click_to_cart_or_buy",
    "cart_to_cart",
    "cart_to_buy",
    "buy_to_buy",
)
POP_RANK_NAMES = (
    "rank_clicks", "rank_carts", "rank_orders",
    "rank_clicks_7d", "rank_carts_7d", "rank_orders_7d",
)

# canonical feature order (the ranker input contract)
FEATURE_NAMES: Tuple[str, ...] = (
    # session-level (reference: model/retrieve.py:121-134)
    "n_events_session", "n_aids_session", "n_clicks_session",
    "n_carts_session", "n_orders_session", "duration_session",
    "only_orders_session",
    # self features (reference :309-334)
    "slf_n", "slf_n_clicks", "slf_n_carts", "slf_n_orders",
    "slf_rank_by_n", "slf_rank_by_n_carts", "slf_rank_by_n_orders",
    "slf_since_ts", "slf_since_ts_clicks", "slf_since_ts_carts",
    "slf_since_ts_orders", "slf_ts_rel_pos_in_session", "slf_ts_order",
    "slf_ts_order_rel", "slf_ts_order_clicks", "slf_ts_order_carts",
    "slf_ts_order_orders", "slf_left_in_cart",
    # aggregated session-aid features (reference :337-364,526-555)
    "n_uniq_aid", "n_uniq_aid_clicks", "n_uniq_aid_carts", "n_uniq_aid_orders",
    "n_aid", "n_aid_clicks", "n_aid_carts", "n_aid_orders",
    "since_ts_aid", "since_ts_aid_clicks", "since_ts_aid_carts",
    "since_ts_aid_orders", "since_session_start_ts_aid",
    "since_session_start_ts_aid_orders", "rel_pos_max_ts_aid_in_session",
    "rel_pos_mean_max_ts_aid_in_session",
    "rel_pos_mean_max_ts_aid_orders_in_session",
    "ts_order_aid", "ts_order_aid_rel", "ts_order_aid_clicks",
    "ts_order_aid_carts", "ts_order_aid_orders", "ts_aid_rel_pos_in_session",
    "rank_by_n_aid",
    # co-visitation features x5 (reference :367-376, :53-61)
    *(f"{n}_{f}" for n in COVIS_NAMES
      for f in ("count", "count_pop", "perc_pop", "rank", "count_rel")),
    # w2vec features (reference :379-389)
    "n_w2vec_all", "dist_w2vec_all", "rank_w2vec_all", "best_rank_w2vec_all",
    "n_w2vec_1_2", "dist_w2vec_1_2", "rank_w2vec_1_2", "best_rank_w2vec_1_2",
    # source flags (reference :558-569)
    "src_any", "src_self", "src_click_to_click", "src_click_to_cart_or_buy",
    "src_cart_to_cart", "src_cart_to_buy", "src_buy_to_buy", "src_w2vec_all",
    "src_w2vec_1_2", "src_pop_cl50",
    # cluster popularity ranks (reference :572-590)
    *(f"{n}_cl50" for n in POP_RANK_NAMES),
    "rank_clicks_cl1", "rank_carts_cl1", "rank_orders_cl1",
    # embedding similarity (reference :604-625)
    "cos_sim_ses_aid", "eucl_dist_ses_aid",
    # cross-source heuristic prior (otto_tpu extension, not in the
    # reference catalogue: recency-weighted normalized co-visit mass —
    # the baseline recommender's score as a ranker input)
    "heur_score",
)
F_TOTAL = len(FEATURE_NAMES)
FEATURE_INDEX = {n: i for i, n in enumerate(FEATURE_NAMES)}

# Candidate-source flag columns, in bit order for the packed meta pull
# (eval.per_source.SOURCES mirrors this tuple; reference source list:
# model/eval_retrieved.py:27-43).
SOURCE_FLAGS: Tuple[str, ...] = (
    "src_any", "src_self", "src_click_to_click", "src_click_to_cart_or_buy",
    "src_cart_to_cart", "src_cart_to_buy", "src_buy_to_buy", "src_w2vec_all",
    "src_w2vec_1_2", "src_pop_cl50",
)


@jax.jit
def _pack_meta_program(cand, feats):
    """[S, C] i32 of ((cand + 1) << n_src) | src_flag_bits: ONE pull
    covers pass A's per-batch host needs (cand max 1.8M needs 21 bits +
    10 flag bits < 31)."""
    idx = jnp.asarray([FEATURE_INDEX[s] for s in SOURCE_FLAGS])
    bits = (feats[:, :, idx] > 0).astype(jnp.int32)
    w = (1 << jnp.arange(len(SOURCE_FLAGS), dtype=jnp.int32))[None, None, :]
    flags = jnp.sum(bits * w, axis=-1)
    return ((cand + 1) << len(SOURCE_FLAGS)) | flags


@jax.jit
def _label_bits_program(cand, session, lab0, lab1, lab2):
    """Device-side label join (the target half of reference
    model/retrieve.py:630-644): bit t of the [S, C] uint8 result = candidate
    is a type-t label for its session. Sorted per-type label KEY tables
    ((session << AID_BITS) | aid, int64) live on device; the host-side
    numpy searchsorted join was the single largest pass-A consumer phase
    at [2048, 512]; on device it is fused into the retrieval dispatch
    stream.

    MUST run (and its inputs upload) under jax.enable_x64(): the 45-bit
    (session, aid) key silently truncates to int32 otherwise — sessions
    past 2^10 then collide and the join is wrong (caught by the streaming
    equivalence test)."""
    key = (
        session.astype(jnp.int64)[:, None] << AID_BITS
    ) | jnp.maximum(cand, 0).astype(jnp.int64)
    bits = jnp.zeros(cand.shape, jnp.uint8)
    for t, lab in enumerate((lab0, lab1, lab2)):
        n = lab.shape[0]
        pos = jnp.searchsorted(lab, key)
        hit = (
            (pos < n)
            & (jnp.take(lab, jnp.minimum(pos, n - 1)) == key)
            & (cand >= 0)
        )
        bits = bits | (hit.astype(jnp.uint8) << t)
    return bits


@partial(jax.jit, static_argnums=(6, 7))
def _label_keep_bits_program(
    cand, session, lab0, lab1, lab2, key, neg_ratio, neg_cap
):
    """_label_bits_program plus the downsample KEEP decision in the same
    dispatch: bits 0-2 of the [S, C] uint8 result are the per-type label
    bits, bits 3-5 the per-type keep bits — all positives plus
    min(neg_ratio * n_pos, neg_cap) uniformly-drawn negatives for sessions
    with at least one positive (reference downsampling semantics,
    model/downsample_retrieved.py:30-45). The host selection path
    (engine/rank.py::downsample_select) runs three [2048, 512] argsort +
    put_along_axis rank computations per batch on the host; here the
    negative choice is scatterless on device: one uniform
    priority per (candidate, type), one row sort, and the neg_cap-th
    smallest priority among the session's negatives as keep threshold."""
    bits = _label_bits_program(cand, session, lab0, lab1, lab2)
    valid = cand >= 0
    S, C = cand.shape
    out = bits
    for t in range(3):
        y = ((bits >> t) & 1) > 0
        pos = y & valid
        n_pos = pos.sum(axis=1)
        max_neg = jnp.minimum(n_pos * neg_ratio, neg_cap)
        prio = jax.random.uniform(
            jax.random.fold_in(key, t), (S, C), jnp.float32
        )
        neg = valid & ~y
        masked = jnp.where(neg, prio, 2.0)   # non-negatives sort past 1.0
        srt = jnp.sort(masked, axis=1)
        # priority of the max_neg-th smallest negative; if the session has
        # fewer negatives than max_neg the threshold lands on a 2.0 pad
        # slot and every available negative keeps (host-path semantics)
        idx = jnp.clip(max_neg - 1, 0, C - 1)
        thr = jnp.take_along_axis(srt, idx[:, None], axis=1)
        keep_neg = neg & (masked <= thr) & (max_neg > 0)[:, None]
        keep = (pos | keep_neg) & (n_pos > 0)[:, None]
        out = out | (keep.astype(jnp.uint8) << (3 + t))
    return out


def label_keys_device(labels) -> tuple:
    """Sorted per-type (session << AID_BITS | aid) int64 key tables on
    device for _label_bits_program. Empty types get a single -1 sentinel
    (matches nothing: real keys are >= 0)."""
    out = []
    with jax.enable_x64():
        for tid in (0, 1, 2):
            lab = labels.for_type(tid)
            key = (
                lab.session.astype(np.int64) << AID_BITS
            ) | lab.aid.astype(np.int64)
            key = np.sort(key)
            if len(key) == 0:
                key = np.array([-1], np.int64)
            out.append(jnp.asarray(key))
    return tuple(out)


class RetrievalContext(NamedTuple):
    """Device-resident stats tables feeding retrieval."""

    covis: Tuple[CoVisTables, ...]          # aligned with COVIS_NAMES
    knn_all: Tuple[jnp.ndarray, jnp.ndarray]   # neighbor [A,k], dist [A,k]
    knn_1_2: Tuple[jnp.ndarray, jnp.ndarray]
    pop_cl50_cand: jnp.ndarray              # [C50, T] aid, -1 pad
    pop_cl50_ranks: jnp.ndarray             # [C50, T, 6]
    pop_cl1_rank: jnp.ndarray               # [A, 6]
    aid_emb: jnp.ndarray                    # [A, D]


class RetrievedBatch:
    """One retrieval batch. `feats` stays ON DEVICE by default (pulling
    ~100MB feature tensors per batch through the host link dominated
    pipeline wall-clock; downsample/scoring gather the few rows they need
    on device instead). `cand`/`ts_order` may arrive as DEVICE arrays and
    are pulled LAZILY on first host access, so a streaming consumer can
    enqueue the next batch's device work before syncing on this one
    (pass-A pipelining: per-batch eager pulls would serialize host work
    against device compute)."""

    __slots__ = ("session", "feats", "_cand", "_ts_order", "_keep")

    def __init__(self, session, cand, feats, ts_order, keep=None):
        self.session = session
        self.feats = feats
        self._cand = cand
        self._ts_order = ts_order
        # host indices of non-padding rows to keep on pull (None = all)
        self._keep = keep

    def _pull(self, x):
        a = np.asarray(x)
        return a[self._keep] if self._keep is not None else a

    @property
    def cand(self) -> np.ndarray:
        if not isinstance(self._cand, np.ndarray):
            self._cand = self._pull(self._cand)
        return self._cand

    @property
    def ts_order(self) -> np.ndarray:
        if not isinstance(self._ts_order, np.ndarray):
            self._ts_order = self._pull(self._ts_order)
        return self._ts_order

    def cand_device(self):
        """[S, C] int32 on device (keep-filtered) for device-side top-k."""
        import jax.numpy as jnp

        if isinstance(self._cand, np.ndarray):
            return jnp.asarray(self._cand)
        if self._keep is None:
            return self._cand
        return self._cand[jnp.asarray(self._keep)]

    def pack_meta(self):
        """Dispatch the packed (cand, src-flags) program: [n_keep, C] int32
        of ((cand + 1) << n_src) | flag_bits, keep-filtered like feats.
        ONE host pull (unpack_meta) then covers everything pass A reads
        per batch, in place of a lazy cand pull and a flag pull.
        None on host-array batches (nothing left to pull)."""
        if isinstance(self._cand, np.ndarray):
            return None
        return _pack_meta_program(self.cand_device(), self.feats)

    def pack_meta_labels(self, label_keys):
        """pack_meta plus the device label join: returns (meta_handle,
        target_bits_handle) or None on host-array batches. label_keys is
        label_keys_device()'s tuple of 3 sorted int64 key tables."""
        if isinstance(self._cand, np.ndarray):
            return None
        cand = self.cand_device()
        meta = _pack_meta_program(cand, self.feats)
        with jax.enable_x64():
            bits = _label_bits_program(
                cand, jnp.asarray(self.session), *label_keys
            )
        return meta, bits

    def pack_meta_labels_select(self, label_keys, key, neg_ratio, neg_cap):
        """pack_meta_labels plus the device-side downsample keep bits
        (bits 3-5 of the tbits pull; RankerConfig.device_select). Same
        two handles, same pull bytes — the keep decision rides free."""
        if isinstance(self._cand, np.ndarray):
            return None
        cand = self.cand_device()
        meta = _pack_meta_program(cand, self.feats)
        with jax.enable_x64():
            bits = _label_keep_bits_program(
                cand, jnp.asarray(self.session), *label_keys, key,
                int(neg_ratio), int(neg_cap),
            )
        return meta, bits

    def unpack_meta(self, meta) -> np.ndarray:
        """Pull + unpack a pack_meta() handle: caches the keep-filtered
        cand on this batch and returns the [n_keep, C] uint16 source-flag
        bits (bit k = eval.per_source.SOURCES[k])."""
        m = np.asarray(meta)
        # meta was packed from the keep-filtered cand_device(); _keep stays
        # set for ts_order's own lazy pull
        self._cand = ((m >> len(SOURCE_FLAGS)) - 1).astype(np.int32)
        return (m & ((1 << len(SOURCE_FLAGS)) - 1)).astype(np.uint16)

    def feats_rows(self, si: np.ndarray, ci: np.ndarray) -> np.ndarray:
        """Gather [n, F] candidate rows (device gather -> small host pull).

        The index set is padded to a power of two before the device gather:
        every distinct index length is a distinct eager-gather program, and
        with per-batch-varying selection counts that means a fresh compile
        per batch per target. Pow2 bucketing caps the compiled-shape set
        at ~log2(S*C).

        Rows cross the link as f16 (returned as f32): half the bytes of
        the selected-row pulls, and the consumers quantize anyway (the
        C15 artifact persists f16; GBDT bins to 64 quantiles). Counts are
        clipped into f16 range on device — values past 65504 share the
        top quantile bin."""
        import jax.numpy as jnp

        n = len(si)
        if n == 0:
            return np.empty((0, self.feats.shape[-1]), np.float32)
        if isinstance(self.feats, np.ndarray):
            return self.feats[si, ci]
        npad = max(8, 1 << (n - 1).bit_length())
        sip = np.zeros(npad, si.dtype)
        cip = np.zeros(npad, ci.dtype)
        sip[:n], cip[:n] = si, ci
        rows = np.asarray(
            jnp.clip(
                self.feats[jnp.asarray(sip), jnp.asarray(cip)],
                -65504.0, 65504.0,
            ).astype(jnp.float16)
        )
        return rows[:n].astype(np.float32)

    def feats_rows_async(self, si: np.ndarray, ci: np.ndarray):
        """Dispatch the clipped-f16 row gather WITHOUT materializing: returns
        (handle, n) where `np.asarray(handle)[:n]` yields the [n, F] f16
        rows. Starts the device->host copy immediately so the pull overlaps
        the caller's host work on other batches (pass A's per-batch serial
        chain — meta pull -> join/select -> row pull — bounded the streaming
        consumer at ~2.8 s/batch while the retrieval program itself runs at
        ~0.25 s/batch). Host-array fallback returns the rows directly."""
        import jax.numpy as jnp

        n = len(si)
        F = self.feats.shape[-1]
        if n == 0:
            return np.empty((0, F), np.float16), 0
        if isinstance(self.feats, np.ndarray):
            return (
                np.clip(self.feats[si, ci], -65504.0, 65504.0)
                .astype(np.float16),
                n,
            )
        npad = max(8, 1 << (n - 1).bit_length())
        sip = np.zeros(npad, si.dtype)
        cip = np.zeros(npad, ci.dtype)
        sip[:n], cip[:n] = si, ci
        handle = jnp.clip(
            self.feats[jnp.asarray(sip), jnp.asarray(cip)], -65504.0, 65504.0
        ).astype(jnp.float16)
        try:
            handle.copy_to_host_async()
        except AttributeError:
            pass
        return handle, n


def _null_to(x, ident, repl):
    return jnp.where(x == ident, repl, x)


@partial(jax.jit, static_argnums=(5, 6, 7))
def retrieve_batch(
    padded: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],  # aid, ts, type [S, L]
    ctx: RetrievalContext,
    cluster: jnp.ndarray,        # [S] int32 session cl50 id
    ses_emb: jnp.ndarray,        # [S, D] session embeddings
    trim_params: jnp.ndarray,    # [3] float32: max_at_1, min_n, delta
    keep_aids: int,
    max_candidates: int,
    _stop_after: str = "",       # profiling hook: 'fanout'|'l1'|'l2'|'compact'
):
    aid, ts, type_ = padded
    S, L = aid.shape

    sa = compute_session_aids(aid, ts, type_, min(keep_aids, L))
    A_k = sa.aid.shape[1]  # may be < keep_aids for short buckets
    ss = compute_session_stats(aid, ts, type_)

    src_aid = sa.aid                                     # [S, A_k]
    src_ok = src_aid >= 0
    ga = jnp.clip(src_aid, 0, None)

    # ---------------- Stage B: source fan-out --------------------------------
    cand_blocks: List[jnp.ndarray] = []
    # per-entry per-source feature blocks; dict name -> block list aligned
    n_cov = len(ctx.covis)

    # self block [S, A_k, 1]
    cand_blocks.append(jnp.where(src_ok, src_aid, -1)[:, :, None])
    block_sizes = [1]
    block_kind = ["self"]

    for t, tabs in enumerate(ctx.covis):
        nbr = tabs.neighbor[ga]                     # [S, A_k, N]
        ok = src_ok[:, :, None] & (nbr >= 0)
        cand_blocks.append(jnp.where(ok, nbr, -1))
        block_sizes.append(nbr.shape[2])
        block_kind.append(f"cov{t}")

    for kind, (nbr_t, dist_t) in (("w2v_all", ctx.knn_all), ("w2v_12", ctx.knn_1_2)):
        nbr = nbr_t[ga]
        ok = src_ok[:, :, None] & (nbr >= 0)
        cand_blocks.append(jnp.where(ok, nbr, -1))
        block_sizes.append(nbr.shape[2])
        block_kind.append(kind)

    P1 = A_k * sum(block_sizes)
    cand_grid = jnp.concatenate(cand_blocks, axis=2)     # [S, A_k, F_src]
    F_src = cand_grid.shape[2]
    src_i_grid = jnp.broadcast_to(
        jnp.arange(A_k, dtype=jnp.int32)[None, :, None], (S, A_k, F_src)
    )

    # per-entry source feature grids (identity values where not applicable)
    def blockify(pieces: List[jnp.ndarray], ident) -> jnp.ndarray:
        """Assemble [S, A_k, F_src] from per-block arrays (None -> identity)."""
        dtype = jnp.float32 if isinstance(ident, float) else jnp.int32
        outs = []
        for bi, size in enumerate(block_sizes):
            if pieces[bi] is None:
                outs.append(jnp.full((S, A_k, size), ident, dtype))
            else:
                outs.append(pieces[bi].astype(dtype))
        return jnp.concatenate(outs, axis=2)

    n_blocks = len(block_sizes)

    def empty_pieces():
        return [None] * n_blocks

    grids: Dict[str, jnp.ndarray] = {}
    # co-vis features per type
    for t, tabs in enumerate(ctx.covis):
        bi = 1 + t
        N = block_sizes[bi]
        rank_cols = jnp.broadcast_to(
            jnp.arange(1, N + 1, dtype=jnp.int32)[None, None, :], (S, A_k, N)
        )
        ok = cand_blocks[bi] >= 0
        for fname, table in (
            ("count", tabs.count[ga]),
            ("count_pop", tabs.count_pop[ga]),
            ("perc_pop", tabs.perc_pop[ga]),
            ("count_rel", tabs.count_rel[ga]),
        ):
            pieces = empty_pieces()
            pieces[bi] = jnp.where(ok, table, 0)
            grids[f"cov{t}_{fname}"] = blockify(pieces, 0)
        pieces = empty_pieces()
        pieces[bi] = jnp.where(ok, rank_cols, SENT)
        grids[f"cov{t}_rank"] = blockify(pieces, SENT)

    for kind, bi_off, (nbr_t, dist_t) in (
        ("w2v_all", n_blocks - 2, ctx.knn_all),
        ("w2v_12", n_blocks - 1, ctx.knn_1_2),
    ):
        bi = bi_off
        N = block_sizes[bi]
        ok = cand_blocks[bi] >= 0
        rank_cols = jnp.broadcast_to(
            jnp.arange(1, N + 1, dtype=jnp.int32)[None, None, :], (S, A_k, N)
        )
        pieces = empty_pieces()
        pieces[bi] = jnp.where(ok, rank_cols, SENT)
        grids[f"{kind}_rank"] = blockify(pieces, SENT)
        pieces = empty_pieces()
        dist_i = (dist_t[ga] * 1.0).astype(jnp.float32)
        pieces[bi] = jnp.where(ok, dist_i, jnp.float32(3.4e38))
        grids[f"{kind}_dist"] = blockify(pieces, 3.4e38)

    # flatten grid entries
    flat_cand = cand_grid.reshape(S, P1)
    flat_i = src_i_grid.reshape(S, P1)
    flat_valid = flat_cand >= 0
    key1 = jnp.where(
        flat_valid, (flat_i << AID_BITS) | flat_cand, SENT
    )

    if _stop_after == "fanout":
        return flat_cand, flat_i, key1
    # ---------------- Stage C: level-1 dedup + trim --------------------------
    # Per-source-aid stats RIDE the level-1 sort as 'carry' payloads (every
    # entry of a (source-aid, cand) segment shares the same source aid, so
    # the value is segment-constant). This replaces ~19 take_along_axis
    # gathers by e_i (the gather-free design of ops/segment.py; ROADMAP
    # D7 asks whether gathers are cheaper on a GPU).
    def carry_of(arr):  # [S, A_k] -> [S, P1] broadcast along the block dim
        return jnp.broadcast_to(arr[:, :, None], (S, A_k, F_src)).reshape(S, P1)

    SA_CARRY = (
        ("src", src_aid),
        ("n_aid", sa.n_aid),
        ("n_aid_clicks", sa.n_aid_clicks),
        ("n_aid_carts", sa.n_aid_carts),
        ("n_aid_orders", sa.n_aid_orders),
        ("rank_by_n_aid", sa.rank_by_n_aid),
        ("rank_by_n_aid_carts", sa.rank_by_n_aid_carts),
        ("rank_by_n_aid_orders", sa.rank_by_n_aid_orders),
        ("max_ts_aid", sa.max_ts_aid),
        ("max_ts_aid_clicks", sa.max_ts_aid_clicks),
        ("max_ts_aid_carts", sa.max_ts_aid_carts),
        ("max_ts_aid_orders", sa.max_ts_aid_orders),
        ("ts_order_aid", sa.ts_order_aid),
        ("ts_order_aid_rel", sa.ts_order_aid_rel),
        ("ts_order_aid_clicks", sa.ts_order_aid_clicks),
        ("ts_order_aid_carts", sa.ts_order_aid_carts),
        ("ts_order_aid_orders", sa.ts_order_aid_orders),
        ("ts_aid_rel_pos_in_session", sa.ts_aid_rel_pos_in_session),
        ("left_in_cart", sa.left_in_cart),
    )

    cols1 = {}
    for t in range(n_cov):
        cols1[f"cov{t}_count"] = (grids[f"cov{t}_count"].reshape(S, P1), "max")
        cols1[f"cov{t}_count_pop"] = (grids[f"cov{t}_count_pop"].reshape(S, P1), "max")
        cols1[f"cov{t}_perc_pop"] = (grids[f"cov{t}_perc_pop"].reshape(S, P1), "max")
        cols1[f"cov{t}_count_rel"] = (grids[f"cov{t}_count_rel"].reshape(S, P1), "max")
        cols1[f"cov{t}_rank"] = (grids[f"cov{t}_rank"].reshape(S, P1), "min")
    for kind in ("w2v_all", "w2v_12"):
        cols1[f"{kind}_rank"] = (grids[f"{kind}_rank"].reshape(S, P1), "min")
        cols1[f"{kind}_dist"] = (grids[f"{kind}_dist"].reshape(S, P1), "min")
    for name, arr in SA_CARRY:
        cols1[f"sa_{name}"] = (carry_of(arr), "carry")

    ks1, red1, end1, _ = seg.rowwise_groupby_scan(key1, cols1)
    # sorted layout: reduced values live at segment-END lanes only
    e_valid = end1
    e_cand = jnp.where(ks1 != SENT, ks1 & AID_MASK, -1)

    def stat_of(name):  # carried per-source-aid stat, aligned to entries
        return red1[f"sa_{name}"]

    is_self = e_valid & (e_cand == stat_of("src"))

    # trim (reference :490-510)
    orders = [
        stat_of("rank_by_n_aid"), stat_of("ts_order_aid"),
        stat_of("ts_order_aid_clicks"), stat_of("ts_order_aid_carts"),
        stat_of("ts_order_aid_orders"),
    ]
    orders = [jnp.where(o == NULL, SENT, o) for o in orders]
    best_order = jnp.minimum(
        jnp.minimum(jnp.minimum(orders[0], orders[1]), orders[2]),
        jnp.minimum(orders[3], orders[4]),
    ).astype(jnp.float32)
    max_at_1, min_n, delta = trim_params[0], trim_params[1], trim_params[2]
    th = jnp.maximum(max_at_1 - delta * (best_order - 1.0), min_n)

    co_ranks = [red1[f"cov{t}_rank"] for t in range(n_cov)]
    best_co = co_ranks[0]
    for r in co_ranks[1:]:
        best_co = jnp.minimum(best_co, r)
    best_w2v = jnp.minimum(red1["w2v_all_rank"], red1["w2v_12_rank"])

    keep = e_valid & (
        is_self
        | (best_co.astype(jnp.float32) <= th)
        | (best_w2v.astype(jnp.float32) <= th)
    )

    if _stop_after == "l1":
        return e_cand, keep, best_co
    # ---------------- Stage D: level-2 groupby candidate ---------------------
    key2_main = jnp.where(keep, e_cand, SENT)

    def masked(arr, ident):
        return jnp.where(keep, arr, ident)

    big_f = jnp.float32(3.4e38)
    cols2: Dict[str, Tuple[jnp.ndarray, str]] = {}
    ones = keep.astype(jnp.int32)
    cols2["n_uniq_aid"] = (ones, "sum")
    cols2["n_uniq_aid_clicks"] = ((keep & (stat_of("n_aid_clicks") > 0)).astype(jnp.int32), "sum")
    cols2["n_uniq_aid_carts"] = ((keep & (stat_of("n_aid_carts") > 0)).astype(jnp.int32), "sum")
    cols2["n_uniq_aid_orders"] = ((keep & (stat_of("n_aid_orders") > 0)).astype(jnp.int32), "sum")
    cols2["n_aid"] = (masked(stat_of("n_aid"), 0), "sum")
    cols2["n_aid_clicks"] = (masked(stat_of("n_aid_clicks"), 0), "sum")
    cols2["n_aid_carts"] = (masked(stat_of("n_aid_carts"), 0), "sum")
    cols2["n_aid_orders"] = (masked(stat_of("n_aid_orders"), 0), "sum")

    mt = stat_of("max_ts_aid")
    min_ts_col = ss.min_ts[:, None]  # baseline keeps per-segment sums in i32
    cols2["max_ts_aid"] = (masked(_null_to(mt, NULL, NEG_SENT), NEG_SENT), "max")
    cols2["sum_rel_max_ts_aid"] = (
        masked(jnp.where(mt == NULL, 0, mt - min_ts_col), 0), "sum")
    for suff in ("clicks", "carts", "orders"):
        a = stat_of(f"max_ts_aid_{suff}")
        cols2[f"max_ts_aid_{suff}"] = (masked(_null_to(a, NULL, NEG_SENT), NEG_SENT), "max")
    mto = stat_of("max_ts_aid_orders")
    has_o = keep & (mto != NULL)
    cols2["sum_rel_max_ts_aid_orders"] = (
        jnp.where(has_o, mto - min_ts_col, 0), "sum")
    cols2["cnt_max_ts_aid_orders"] = (has_o.astype(jnp.int32), "sum")

    for name in (
        "ts_order_aid", "ts_order_aid_rel", "ts_order_aid_clicks",
        "ts_order_aid_carts", "ts_order_aid_orders", "rank_by_n_aid",
    ):
        a = stat_of(name)
        cols2[name] = (masked(_null_to(a, NULL, SENT), SENT), "min")
    relp = stat_of("ts_aid_rel_pos_in_session")
    cols2["sum_rel_pos"] = (masked(jnp.where(relp == NULL, 0, relp), 0), "sum")

    for t in range(n_cov):
        cnt = masked(red1[f"cov{t}_count"], 0)
        cols2[f"cov{t}_count"] = (cnt, "sum")
        for f in ("count_pop", "perc_pop", "count_rel"):
            cols2[f"cov{t}_num_{f}"] = (masked(red1[f"cov{t}_{f}"], 0) * cnt, "sum")
        rk = red1[f"cov{t}_rank"]
        cols2[f"cov{t}_num_rank"] = (
            masked(jnp.where(rk == SENT, 0, rk), 0) * cnt, "sum")
        cols2[f"cov{t}_best_rank"] = (masked(rk, SENT), "min")

    for kind in ("w2v_all", "w2v_12"):
        rk = red1[f"{kind}_rank"]
        present = keep & (rk != SENT)
        cols2[f"{kind}_n"] = (present.astype(jnp.int32), "sum")
        cols2[f"{kind}_sum_rank"] = (jnp.where(present, rk, 0), "sum")
        cols2[f"{kind}_best_rank"] = (masked(rk, SENT), "min")
        d = red1[f"{kind}_dist"]
        cols2[f"{kind}_sum_dist"] = (jnp.where(present, d, 0.0), "sum")

    # self features ride as (is_self ? stat : identity)
    def slf(name, red, ident, null_src=NULL, null_dst=None):
        a = stat_of(name)
        if null_dst is not None:
            a = _null_to(a, null_src, null_dst)
        return (jnp.where(is_self & keep, a, ident), red)

    cols2["slf_present"] = ((is_self & keep).astype(jnp.int32), "sum")
    cols2["slf_n"] = slf("n_aid", "sum", 0)
    cols2["slf_n_clicks"] = slf("n_aid_clicks", "sum", 0)
    cols2["slf_n_carts"] = slf("n_aid_carts", "sum", 0)
    cols2["slf_n_orders"] = slf("n_aid_orders", "sum", 0)
    cols2["slf_rank_by_n"] = slf("rank_by_n_aid", "min", SENT, NULL, SENT)
    cols2["slf_rank_by_n_carts"] = slf("rank_by_n_aid_carts", "min", SENT, NULL, SENT)
    cols2["slf_rank_by_n_orders"] = slf("rank_by_n_aid_orders", "min", SENT, NULL, SENT)
    cols2["slf_max_ts"] = slf("max_ts_aid", "max", NEG_SENT, NULL, NEG_SENT)
    cols2["slf_max_ts_clicks"] = slf("max_ts_aid_clicks", "max", NEG_SENT, NULL, NEG_SENT)
    cols2["slf_max_ts_carts"] = slf("max_ts_aid_carts", "max", NEG_SENT, NULL, NEG_SENT)
    cols2["slf_max_ts_orders"] = slf("max_ts_aid_orders", "max", NEG_SENT, NULL, NEG_SENT)
    cols2["slf_ts_rel_pos"] = slf("ts_aid_rel_pos_in_session", "min", SENT, NULL, SENT)
    cols2["slf_ts_order"] = slf("ts_order_aid", "min", SENT, NULL, SENT)
    cols2["slf_ts_order_rel"] = slf("ts_order_aid_rel", "min", SENT, NULL, SENT)
    cols2["slf_ts_order_clicks"] = slf("ts_order_aid_clicks", "min", SENT, NULL, SENT)
    cols2["slf_ts_order_carts"] = slf("ts_order_aid_carts", "min", SENT, NULL, SENT)
    cols2["slf_ts_order_orders"] = slf("ts_order_aid_orders", "min", SENT, NULL, SENT)
    cols2["slf_left_in_cart"] = slf("left_in_cart", "sum", 0)

    # popularity candidates appended as extra entries (outer join,
    # reference :572-585)
    T_pop = ctx.pop_cl50_cand.shape[1]
    gc = jnp.clip(cluster, 0, ctx.pop_cl50_cand.shape[0] - 1)
    pop_cand = ctx.pop_cl50_cand[gc]                 # [S, T]
    pop_ranks = ctx.pop_cl50_ranks[gc]               # [S, T, 6]
    pop_valid = pop_cand >= 0
    # keep only top-20-by-any-rank (reference :580-582)
    pop_best = jnp.min(pop_ranks, axis=2)
    pop_valid = pop_valid & (pop_best <= 20)

    key2 = jnp.concatenate(
        [key2_main, jnp.where(pop_valid, pop_cand, SENT)], axis=1
    )
    P2 = key2.shape[1]

    def pad_main(arr, ident):
        fill = jnp.full((S, T_pop), ident, arr.dtype)
        return jnp.concatenate([arr, fill], axis=1)

    cols2p = {n: (pad_main(a, _identity(red)), red) for n, (a, red) in cols2.items()}
    # pop rank columns: only pop entries carry them
    for pi in range(6):
        pr = jnp.where(pop_valid, pop_ranks[:, :, pi], SENT)
        fill = jnp.full((S, P1), SENT, jnp.int32)
        cols2p[f"pop_{pi}"] = (jnp.concatenate([fill, pr], axis=1), "min")
    cols2p["pop_present"] = (
        jnp.concatenate(
            [jnp.zeros((S, P1), jnp.int32), pop_valid.astype(jnp.int32)], axis=1
        ),
        "sum",
    )

    ks2, red2, end2, _ = seg.rowwise_groupby_scan(key2, cols2p)

    if _stop_after == "l2":
        return ks2, red2["n_uniq_aid"]
    # ---------------- Stage E: compaction ------------------------------------
    # Fused with the recency-priority selection: ONE payload-transport sort
    # keyed on the per-candidate ts_order priority (segment ends only) both
    # compacts the groupby result and applies the top-C cut — the separate
    # compaction sort + stacked column gathers of the old layout disappear.
    ts_order = jnp.where(
        end2, _null_to(red2["ts_order_aid"], SENT, 999), SENT
    )
    prio = jnp.where(end2, jnp.clip(ts_order, 0, 999), SENT)
    names2 = list(red2)
    pk, comp = seg.rowwise_transport_sort(
        prio,
        [jnp.where(end2, ks2, -1), ts_order] + [red2[n] for n in names2],
    )
    # a candidate cap beyond the union's padded lane width is a no-op (there
    # can be no more candidates than lanes): clip instead of mis-slicing
    C = min(max_candidates, pk.shape[1])
    slot_ok = pk[:, :C] != SENT
    cand = jnp.where(slot_ok, comp[0][:, :C], -1)
    valid = cand >= 0
    ts_order_c = jnp.where(slot_ok, comp[1][:, :C], SENT)
    r2: Dict[str, jnp.ndarray] = {}
    for i, n in enumerate(names2):
        ident = seg._reduce_identity(cols2p[n][0].dtype, cols2p[n][1])
        r2[n] = jnp.where(slot_ok, comp[2 + i][:, :C], ident)

    if _stop_after == "compact":
        return cand, ts_order_c
    if _stop_after == "r2":
        return cand, tuple(r2.values())
    # ---------------- final feature assembly --------------------------------
    f: Dict[str, jnp.ndarray] = {}

    def out_i(name, arr, null_ident=None, null_val=NULL):
        x = arr
        if null_ident is not None:
            x = _null_to(x, null_ident, null_val)
        f[name] = jnp.where(valid, x, null_val).astype(jnp.float32)

    # session-level (broadcast)
    for name, arr in (
        ("n_events_session", ss.n_events), ("n_aids_session", ss.n_aids),
        ("n_clicks_session", ss.n_clicks), ("n_carts_session", ss.n_carts),
        ("n_orders_session", ss.n_orders), ("duration_session", ss.duration),
        ("only_orders_session", ss.only_orders),
    ):
        f[name] = jnp.broadcast_to(
            arr[:, None].astype(jnp.float32), (S, C)
        ) * valid.astype(jnp.float32)

    max_ts_s = ss.max_ts[:, None]
    min_ts_s = ss.min_ts[:, None]
    span1 = (ss.max_ts - ss.min_ts + 1)[:, None].astype(jnp.float32)

    # self
    out_i("slf_n", r2["slf_n"])
    out_i("slf_n_clicks", r2["slf_n_clicks"])
    out_i("slf_n_carts", r2["slf_n_carts"])
    out_i("slf_n_orders", r2["slf_n_orders"])
    out_i("slf_rank_by_n", r2["slf_rank_by_n"], SENT)
    out_i("slf_rank_by_n_carts", r2["slf_rank_by_n_carts"], SENT)
    out_i("slf_rank_by_n_orders", r2["slf_rank_by_n_orders"], SENT)
    for suff in ("", "_clicks", "_carts", "_orders"):
        mts = r2[f"slf_max_ts{suff}"]
        since = jnp.where(mts == NEG_SENT, NULL, max_ts_s - mts)
        out_i(f"slf_since_ts{suff}", since)
    out_i("slf_ts_rel_pos_in_session", r2["slf_ts_rel_pos"], SENT)
    out_i("slf_ts_order", r2["slf_ts_order"], SENT)
    out_i("slf_ts_order_rel", r2["slf_ts_order_rel"], SENT)
    out_i("slf_ts_order_clicks", r2["slf_ts_order_clicks"], SENT)
    out_i("slf_ts_order_carts", r2["slf_ts_order_carts"], SENT)
    out_i("slf_ts_order_orders", r2["slf_ts_order_orders"], SENT)
    out_i("slf_left_in_cart", r2["slf_left_in_cart"])

    # aggregates
    n_uniq = jnp.maximum(r2["n_uniq_aid"], 1)
    out_i("n_uniq_aid", r2["n_uniq_aid"])
    out_i("n_uniq_aid_clicks", r2["n_uniq_aid_clicks"])
    out_i("n_uniq_aid_carts", r2["n_uniq_aid_carts"])
    out_i("n_uniq_aid_orders", r2["n_uniq_aid_orders"])
    out_i("n_aid", r2["n_aid"])
    out_i("n_aid_clicks", r2["n_aid_clicks"])
    out_i("n_aid_carts", r2["n_aid_carts"])
    out_i("n_aid_orders", r2["n_aid_orders"])

    for suff in ("", "_clicks", "_carts", "_orders"):
        mts = r2[f"max_ts_aid{suff}"]
        since = jnp.where(mts == NEG_SENT, NULL, max_ts_s - mts)
        out_i(f"since_ts_aid{suff}", since)

    mt_max = r2["max_ts_aid"]
    has_mt = mt_max != NEG_SENT
    out_i("since_session_start_ts_aid",
          jnp.where(has_mt, mt_max - min_ts_s, NULL))
    mto_max = r2["max_ts_aid_orders"]
    out_i("since_session_start_ts_aid_orders",
          jnp.where(mto_max != NEG_SENT, mto_max - min_ts_s, NULL))
    out_i("rel_pos_max_ts_aid_in_session",
          jnp.where(has_mt,
                    ((mt_max - min_ts_s).astype(jnp.float32) / span1 * 100)
                    .astype(jnp.int32), NULL))
    # sums are session-start-relative, so mean - min_ts == sum_rel / n
    mean_rel_mt = (r2["sum_rel_max_ts_aid"].astype(jnp.float32)
                   / n_uniq.astype(jnp.float32))
    out_i("rel_pos_mean_max_ts_aid_in_session",
          jnp.where(has_mt, (mean_rel_mt / span1 * 100).astype(jnp.int32),
                    NULL))
    cnt_o = r2["cnt_max_ts_aid_orders"]
    mean_rel_mto = (
        r2["sum_rel_max_ts_aid_orders"].astype(jnp.float32)
        / jnp.maximum(cnt_o, 1).astype(jnp.float32)
    )
    out_i("rel_pos_mean_max_ts_aid_orders_in_session",
          jnp.where(cnt_o > 0,
                    (mean_rel_mto / span1 * 100).astype(jnp.int32), NULL))

    # ts_order_aid: candidates only from pop get 999 (reference :599)
    f["ts_order_aid"] = jnp.where(valid, jnp.clip(ts_order_c, 0, 999), NULL).astype(jnp.float32)
    out_i("ts_order_aid_rel", r2["ts_order_aid_rel"], SENT)
    out_i("ts_order_aid_clicks", r2["ts_order_aid_clicks"], SENT)
    out_i("ts_order_aid_carts", r2["ts_order_aid_carts"], SENT)
    out_i("ts_order_aid_orders", r2["ts_order_aid_orders"], SENT)
    mean_rp = (r2["sum_rel_pos"].astype(jnp.float32) / n_uniq.astype(jnp.float32)).astype(jnp.int32)
    out_i("ts_aid_rel_pos_in_session", jnp.where(r2["n_uniq_aid"] > 0, mean_rp, NULL))
    out_i("rank_by_n_aid", r2["rank_by_n_aid"], SENT)

    # co-vis: count-weighted means (reference :367-376); absent -> -1
    for t, name in enumerate(COVIS_NAMES):
        cnt = r2[f"cov{t}_count"]
        has = cnt > 0
        out_i(f"{name}_count", jnp.where(has, cnt, NULL))
        for ff in ("count_pop", "perc_pop", "count_rel", "rank"):
            num = r2[f"cov{t}_num_{ff}"]
            mean_v = (num.astype(jnp.float32)
                      / jnp.maximum(cnt, 1).astype(jnp.float32)).astype(jnp.int32)
            out_i(f"{name}_{ff}", jnp.where(has, mean_v, NULL))

    # w2vec aggregates (reference :379-389); absent -> -1
    for kind, out_suff in (("w2v_all", "all"), ("w2v_12", "1_2")):
        n = r2[f"{kind}_n"]
        has = n > 0
        out_i(f"n_w2vec_{out_suff}", n)
        mean_d = jnp.where(
            has, r2[f"{kind}_sum_dist"] / jnp.maximum(n, 1).astype(jnp.float32),
            NULL,
        )
        f[f"dist_w2vec_{out_suff}"] = jnp.where(valid, mean_d, NULL).astype(jnp.float32)
        mean_r = (r2[f"{kind}_sum_rank"].astype(jnp.float32)
                  / jnp.maximum(n, 1).astype(jnp.float32)).astype(jnp.int32)
        out_i(f"rank_w2vec_{out_suff}", jnp.where(has, mean_r, NULL))
        out_i(f"best_rank_w2vec_{out_suff}",
              jnp.where(has, r2[f"{kind}_best_rank"], NULL))

    # source flags (reference :558-569)
    f["src_any"] = valid.astype(jnp.float32)
    f["src_self"] = (valid & (r2["slf_present"] > 0)).astype(jnp.float32)
    for t, name in enumerate(COVIS_NAMES):
        n_t = r2["n_aid_clicks"] if t in (0, 1) else (
            r2["n_aid_carts"] if t in (2, 3) else r2["n_aid_orders"]
        )
        f[f"src_{name}"] = (
            valid & (n_t > 0) & (r2[f"cov{t}_count"] > 0)
        ).astype(jnp.float32)
    f["src_w2vec_all"] = (valid & (r2["w2v_all_n"] > 0)).astype(jnp.float32)
    f["src_w2vec_1_2"] = (valid & (r2["w2v_12_n"] > 0)).astype(jnp.float32)
    f["src_pop_cl50"] = (valid & (r2["pop_present"] > 0)).astype(jnp.float32)

    # popularity ranks
    for pi, pname in enumerate(POP_RANK_NAMES):
        out_i(f"{pname}_cl50", r2[f"pop_{pi}"], SENT)
    cl1 = ctx.pop_cl1_rank[jnp.clip(cand, 0, None)]
    for pi, pname in enumerate(("rank_clicks_cl1", "rank_carts_cl1", "rank_orders_cl1")):
        f[pname] = jnp.where(valid, cl1[:, :, pi], NULL).astype(jnp.float32)

    # embedding similarity (reference :604-625)
    cand_vec = ctx.aid_emb[jnp.clip(cand, 0, None)]          # [S, C, D]
    # full f32: eucl below is sqrt(|s|^2 + |c|^2 - 2 s.c), which cancels for
    # close pairs, and TF32 would move both features off the CPU reference
    dot = jnp.einsum("sd,scd->sc", ses_emb, cand_vec,
                     precision=jax.lax.Precision.HIGHEST)
    n_s = jnp.linalg.norm(ses_emb, axis=1)[:, None]
    n_c = jnp.linalg.norm(cand_vec, axis=2)
    cos = dot / jnp.maximum(n_s * n_c, 1e-9)
    eucl = jnp.sqrt(jnp.maximum(
        n_s**2 + n_c**2 - 2 * dot, 0.0
    ))
    has_emb = n_c > 1e-9
    f["cos_sim_ses_aid"] = jnp.where(valid & has_emb, cos, 0.0).astype(jnp.float32)
    f["eucl_dist_ses_aid"] = jnp.where(valid & has_emb, eucl, NULL).astype(jnp.float32)

    # heuristic prior: self recency boost + summed normalized co-visit mass
    # (otto_tpu extension — the baseline recommender's score as an input)
    heur = jnp.where(r2["slf_present"] > 0,
                     10.0 / jnp.maximum(f["slf_ts_order"], 1.0), 0.0)
    for name in COVIS_NAMES:
        crel = f[f"{name}_count_rel"]
        heur = heur + jnp.where(crel > 0, crel / 100.0, 0.0)
    f["heur_score"] = jnp.where(valid, heur, 0.0).astype(jnp.float32)

    feats = jnp.stack([f[name] for name in FEATURE_NAMES], axis=2)
    ts_out = jnp.clip(ts_order_c, 0, 999)
    if C < max_candidates:
        # keep the [S, max_candidates] output contract even when the cap
        # exceeds this bucket's lane width (batches from different length
        # buckets must concatenate)
        pad = max_candidates - C
        cand = jnp.pad(cand, ((0, 0), (0, pad)), constant_values=-1)
        feats = jnp.pad(feats, ((0, 0), (0, pad), (0, 0)))
        ts_out = jnp.pad(ts_out, ((0, 0), (0, pad)), constant_values=999)
    return cand, feats, ts_out


def _identity(red: str):
    if red == "sum":
        return 0
    if red == "min":
        return SENT
    if red == "max":
        return NEG_SENT
    raise ValueError(red)


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SessionLookup:
    """Sorted-array session -> (cluster, embedding) join. Replaces per-
    session Python dict lookups (a 1.67M-session pass did ~3.3M dict gets
    + list building per epoch); one vectorized
    searchsorted per batch instead."""

    ids: np.ndarray       # [n] sorted unique session ids (int)
    cluster: np.ndarray   # [n] int32 cl50 assignment
    emb: np.ndarray       # [n, D] float32 session embeddings

    @staticmethod
    def build(ids: np.ndarray, cluster: np.ndarray, emb: np.ndarray) -> "SessionLookup":
        ids = np.asarray(ids)
        order = np.argsort(ids, kind="stable")
        return SessionLookup(
            ids=ids[order],
            cluster=np.asarray(cluster, np.int32)[order],
            emb=np.asarray(emb, np.float32)[order],
        )

    @staticmethod
    def from_dicts(cluster: Dict[int, int], emb: Dict[int, np.ndarray],
                   dim: int) -> "SessionLookup":
        """Convenience for tests / tiny runs."""
        ids = np.array(sorted(set(cluster) | set(emb)), np.int64)
        cl = np.array([cluster.get(int(s), 0) for s in ids], np.int32)
        em = np.stack([
            np.asarray(emb.get(int(s), np.zeros(dim, np.float32)), np.float32)
            for s in ids
        ]) if len(ids) else np.zeros((0, dim), np.float32)
        return SessionLookup(ids=ids, cluster=cl, emb=em)

    def lookup(self, sessions: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized join; misses get cluster 0 / zero embedding."""
        pos = np.searchsorted(self.ids, sessions)
        pos_c = np.clip(pos, 0, max(len(self.ids) - 1, 0))
        if len(self.ids) == 0:
            return (
                np.zeros(len(sessions), np.int32),
                np.zeros((len(sessions), self.emb.shape[1]), np.float32),
            )
        hit = self.ids[pos_c] == sessions
        cl = np.where(hit, self.cluster[pos_c], 0).astype(np.int32)
        em = np.where(hit[:, None], self.emb[pos_c], 0.0).astype(np.float32)
        return cl, em


@dataclasses.dataclass
class Retriever:
    """Host-side driver: streams padded session batches through
    retrieve_batch (reference main loop: model/retrieve.py:700-719).

    With `mesh` (a parallel.mesh.MeshContext), every batch's session
    tensors are placed sharded over the data axis before dispatch, so the
    jitted retrieval program runs data-parallel (source tables replicate);
    batch sizes are already powers of two >= 8, so they divide any
    power-of-two data-axis size."""

    ctx: RetrievalContext
    cfg: RetrievalConfig
    sessions: SessionLookup              # session -> (cl50, embedding)
    mesh: Optional[object] = None        # parallel.mesh.MeshContext

    def run(
        self,
        test: Events,
        batch_sessions: int = 256,
        keep_aids: Optional[int] = None,
        max_candidates: Optional[int] = None,
    ) -> List[RetrievedBatch]:
        """Retrieve everything into one list. Holds EVERY batch's [S, C, F]
        device feature tensor alive at once (~200 KB per session); for
        larger runs use iter_run (streaming) so each
        batch's features are freed after consumption."""
        return list(
            self.iter_run(test, batch_sessions, keep_aids, max_candidates)
        )

    def iter_run(
        self,
        test: Events,
        batch_sessions: int = 256,
        keep_aids: Optional[int] = None,
        max_candidates: Optional[int] = None,
    ):
        keep_aids = keep_aids or self.cfg.max_session_aids
        max_candidates = max_candidates or self.cfg.max_candidates
        trim = jnp.asarray(
            [
                self.cfg.trim_max_at_order_1,
                self.cfg.trim_min,
                (self.cfg.trim_max_at_order_1 - self.cfg.trim_min)
                / (self.cfg.trim_min_at_order - 1),
            ],
            jnp.float32,
        )
        for p in pack_sessions(test, self.cfg.session_len_buckets):
            log.debug(
                "retrieve bucket L=%d: %d sessions", p.aid.shape[1], p.n_sessions
            )
            # batch size: next power of two >= bucket population, capped at
            # batch_sessions — keeps the compiled-shape set small (one
            # program per power of two) and every batch divisible by a
            # power-of-two data axis
            size = min(batch_sessions, 1 << max(3, p.n_sessions - 1).bit_length())
            put = _data_put(self.mesh, size)
            for mb in iter_microbatches(p, size):
                cluster, semb = self.sessions.lookup(mb.session)
                cand, feats, ts_order = retrieve_batch(
                    (put(mb.aid), put(mb.ts), put(mb.type)),
                    self.ctx,
                    put(cluster),
                    put(semb),
                    trim,
                    keep_aids,
                    max_candidates,
                )
                keep = mb.session >= 0
                keep_idx = None if bool(keep.all()) else np.nonzero(keep)[0]
                yield RetrievedBatch(
                    session=mb.session[keep],
                    # cand/ts_order handed over as DEVICE arrays: pulling
                    # them here would sync the queue per batch and stall
                    # the consumer's lookahead (lazy pull in the class)
                    cand=cand,
                    feats=feats if keep_idx is None
                    else feats[jnp.asarray(keep_idx)],
                    ts_order=ts_order,
                    keep=keep_idx,
                )


def _data_put(mesh_ctx, batch_size: int):
    """Device-put callback for batch arrays: sharded over the data axis when
    a mesh is active and divides the batch, plain jnp.asarray otherwise."""
    if mesh_ctx is None or mesh_ctx.n_data <= 1 or batch_size % mesh_ctx.n_data:
        return jnp.asarray
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh_ctx.mesh, P(mesh_ctx.data_axis))

    def put(x):
        return jax.device_put(np.asarray(x), sh)

    return put


def join_labels(
    batches: List[RetrievedBatch], labels: Labels
) -> List[np.ndarray]:
    """Per batch: [S, C, 3] 0/1 targets (reference :630-644)."""
    by_type = {}
    for tid in (0, 1, 2):
        lab = labels.for_type(tid)
        key = lab.session.astype(np.int64) << AID_BITS | lab.aid.astype(np.int64)
        by_type[tid] = np.sort(key)
    out = []
    for b in batches:
        S, C = b.cand.shape
        tgt = np.zeros((S, C, 3), np.float32)
        key = (
            b.session.astype(np.int64)[:, None] << AID_BITS
        ) | np.maximum(b.cand, 0).astype(np.int64)
        for tid in (0, 1, 2):
            srt = by_type[tid]
            if len(srt) == 0:
                continue
            pos = np.searchsorted(srt, key)
            hit = (pos < len(srt)) & (srt[np.minimum(pos, len(srt) - 1)] == key)
            tgt[:, :, tid] = (hit & (b.cand >= 0)).astype(np.float32)
        out.append(tgt)
    return out
