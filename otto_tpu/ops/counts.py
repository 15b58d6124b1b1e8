"""Sparse (aid, aid_next) -> count accumulation on device.

The reference's hierarchical merge (per-chunk counts -> RAM-bounded partial
groupby-sums -> prune -> global groupby-sum, reference:
model/count_co_events.py:103-181) becomes a fixed-capacity device-resident
sorted table plus a sort-compress merge step: concat new compressed pairs,
lexicographic sort, segment-sum duplicates, and — on overflow — keep the
top-capacity pairs by count (the analogue of MIN_COUNT_IN_PART pruning +
head(max_rows), reference: model/count_co_events.py:152-158).

All shapes static => one compiled merge program reused for every batch.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from otto_tpu.ops import segment as seg

SENTINEL = seg.SENTINEL


class CountTable(NamedTuple):
    """Sorted sparse count table; rows >= n are padding (aid == SENTINEL)."""

    aid: jnp.ndarray        # [C] int32 ascending (SENTINEL padded)
    aid_next: jnp.ndarray   # [C] int32
    count: jnp.ndarray      # [C] int32
    n: jnp.ndarray          # []  int32 number of valid rows

    @property
    def capacity(self) -> int:
        return self.aid.shape[0]


def empty_table(capacity: int) -> CountTable:
    return CountTable(
        aid=jnp.full((capacity,), SENTINEL, jnp.int32),
        aid_next=jnp.full((capacity,), SENTINEL, jnp.int32),
        count=jnp.zeros((capacity,), jnp.int32),
        n=jnp.zeros((), jnp.int32),
    )


def _keep_topk_by_count(
    aid: jnp.ndarray, aid_next: jnp.ndarray, count: jnp.ndarray, k: int
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Keep the k largest-count rows, restore key order. Padding (count==0)
    naturally sorts last."""
    neg_c = -count
    c_s, a_s, b_s = lax.sort((neg_c, aid, aid_next), num_keys=1, is_stable=True)
    a_k, b_k, c_k = a_s[:k], b_s[:k], -c_s[:k]
    # restore (aid, aid_next) ascending order; zero-count rows -> SENTINEL
    pad = c_k == 0
    a_k = jnp.where(pad, SENTINEL, a_k)
    b_k = jnp.where(pad, SENTINEL, b_k)
    a_o, b_o, c_o = lax.sort((a_k, b_k, c_k), num_keys=2)
    return a_o, b_o, jnp.where(a_o == SENTINEL, 0, c_o)


def merge_into_impl(
    table: CountTable,
    aid: jnp.ndarray,
    aid_next: jnp.ndarray,
    count: jnp.ndarray,
) -> CountTable:
    """Merge a batch of (possibly compressed) pair counts into the table.

    Batch rows with aid == SENTINEL (or count == 0) are ignored. On overflow
    the smallest-count pairs are dropped (tracked upstream as an explicit
    loss bound, unlike the reference's silent head() truncation)."""
    C = table.capacity
    valid = (aid != SENTINEL) & (count > 0)
    k1 = jnp.concatenate([table.aid, jnp.where(valid, aid, SENTINEL)])
    k2 = jnp.concatenate([table.aid_next, jnp.where(valid, aid_next, SENTINEL)])
    v = jnp.concatenate([table.count, jnp.where(valid, count, 0)])
    uk1, uk2, uv, n_unique = seg.sort_compress(k1, k2, v)

    # overflow truncation costs two extra full sorts; skip it when the
    # merged uniques fit (the common case — uniques sit sorted at the front)
    def trunc(_):
        return _keep_topk_by_count(uk1, uk2, uv, C)

    def no_trunc(_):
        return uk1[:C], uk2[:C], uv[:C]

    a, b, c = lax.cond(n_unique > C, trunc, no_trunc, None)
    n = jnp.minimum(n_unique, C)
    return CountTable(a, b, c, n)


merge_into = jax.jit(merge_into_impl, donate_argnums=(0,))


def merge_runs_impl(runs: Tuple[CountTable, ...]) -> CountTable:
    """LOSSLESS merge of sorted-or-raw runs: concat + sort + segment-sum.
    Output capacity = sum of input capacities, so no truncation can occur
    (the ladder invariant: a level-k run holds the pairs of arity^k
    microbatches and is sized to fit all of them). The result is left
    UNCOMPACTED (unique keys scattered at segment ends) — the next merge
    re-sorts anyway, and skipping the compaction sort halves the cost."""
    k1 = jnp.concatenate([r.aid for r in runs])
    k2 = jnp.concatenate([r.aid_next for r in runs])
    v = jnp.concatenate([r.count for r in runs])
    uk1, uk2, uv, n = seg.sort_compress_ends(k1, k2, v)
    return CountTable(uk1, uk2, uv, n)


merge_runs = jax.jit(merge_runs_impl)


def merge_runs_compact_impl(runs: Tuple[CountTable, ...]) -> CountTable:
    """merge_runs with front-compaction (uniques packed at the front in key
    order) so the result can be SLICED down to its occupancy — the squeeze
    step that keeps ladder runs dense instead of padded."""
    k1 = jnp.concatenate([r.aid for r in runs])
    k2 = jnp.concatenate([r.aid_next for r in runs])
    v = jnp.concatenate([r.count for r in runs])
    uk1, uk2, uv, n = seg.sort_compress(k1, k2, v)
    return CountTable(uk1, uk2, uv, n)


merge_runs_compact = jax.jit(merge_runs_compact_impl)


def merge_runs_compact_raw_impl(runs: Tuple[CountTable, ...]) -> CountTable:
    """merge_runs_compact specialized to RAW unit-count runs (count == 1 on
    every valid row, exactly as the pair grids emit them): the count column
    is DERIVED from segment lengths after a keys-only sort — the dominant
    level-0 ladder sort carries 2 operands instead of 3, and the value
    scan collapses to one cummax. Semantics: groupby(k1, k2).count
    (reference: model/count_co_events.py:64-72).

    PRECONDITION: every input run must be raw (count == 1 wherever
    aid != SENTINEL); the count column is IGNORED, so aggregated runs
    passed here would get silently wrong counts. CoVisCounter._push
    guarantees this (level-0 entries are always raw emit output); the
    invariant is asserted in tests (tests/test_covis.py)."""
    k1 = jnp.concatenate([r.aid for r in runs])
    k2 = jnp.concatenate([r.aid_next for r in runs])
    k1s, k2s = lax.sort((k1, k2), num_keys=2)
    first = (k1s != seg._shift_right(k1s, seg.NEG_SENTINEL)) | (
        k2s != seg._shift_right(k2s, seg.NEG_SENTINEL)
    )
    n = k1s.shape[0]
    pos = lax.broadcasted_iota(jnp.int32, (n,), 0)
    start = lax.cummax(jnp.where(first, pos, 0))
    length = pos - start + 1
    is_end = seg._shift_left(first, True) & (k1s != SENTINEL)
    ck1 = jnp.where(is_end, k1s, SENTINEL)
    ck2 = jnp.where(is_end, k2s, SENTINEL)
    uk1, uk2, uv = lax.sort((ck1, ck2, length), num_keys=2)
    uv = jnp.where(uk1 == SENTINEL, 0, uv)
    n_unique = jnp.sum(is_end).astype(jnp.int32)
    return CountTable(uk1, uk2, uv, n_unique)


merge_runs_compact_raw = jax.jit(merge_runs_compact_raw_impl)


@partial(jax.jit, static_argnums=(1,))
def slice_table(t: CountTable, size: int) -> CountTable:
    """First `size` rows of a COMPACTED table (caller guarantees n <= size)."""
    return CountTable(t.aid[:size], t.aid_next[:size], t.count[:size], t.n)


def _select_by_tag(tag: jnp.ndarray, values: Tuple[int, ...]) -> jnp.ndarray:
    """values[tag] via an arithmetic select chain instead of a dynamic
    gather on a [C]-long index vector (ROADMAP D7)."""
    out = jnp.full(tag.shape, values[0] if values else 0, jnp.int32)
    for i, val in enumerate(values):
        out = jnp.where(tag == i, jnp.int32(val), out)
    return out


@partial(jax.jit, static_argnums=(2, 3))
def merge_bounded_tagged(
    table: CountTable,
    run: CountTable,
    min_count_in_part: Tuple[int, ...],
    stride: int,
) -> CountTable:
    """Merge a run into the bounded top table of the type-tagged keyspace.

    On overflow, first drop pairs below the PER-TYPE partial-aggregate
    min-count (the reference's MIN_COUNT_IN_PART pruning applied to
    RAM-bounded merge slices, reference: model/count_co_events.py:152-158,
    config.py:63), then keep the top-capacity pairs by count."""
    C = table.capacity
    k1 = jnp.concatenate([table.aid, run.aid])
    k2 = jnp.concatenate([table.aid_next, run.aid_next])
    v = jnp.concatenate([table.count, run.count])
    uk1, uk2, uv, n_unique = seg.sort_compress(k1, k2, v)

    def trunc(_):
        tag = jnp.where(uk1 == SENTINEL, 0, uk1 // stride)
        minc = _select_by_tag(tag, min_count_in_part)
        keep = uv >= minc
        a = jnp.where(keep, uk1, SENTINEL)
        b = jnp.where(keep, uk2, SENTINEL)
        c = jnp.where(keep, uv, 0)
        return _keep_topk_by_count(a, b, c, C)

    def no_trunc(_):
        return uk1[:C], uk2[:C], uv[:C]

    a, b, c = lax.cond(n_unique > C, trunc, no_trunc, None)
    n = jnp.sum(c[:C] > 0).astype(jnp.int32)
    return CountTable(a, b, c, n)


@partial(jax.jit, static_argnums=(1, 2))
def prune_tagged(
    table: CountTable, min_count_in_part: Tuple[int, ...], stride: int
) -> CountTable:
    """Drop rows below their type's in-part min count and re-compact (front-
    packed, key order). Applied to fully-merged runs about to spill — the
    reference prunes its RAM-bounded partial aggregates with the same
    per-type thresholds (reference: model/count_co_events.py:131-133,
    152-158; config.py:63 MIN_COUNT_IN_PART)."""
    tag = jnp.where(table.aid == SENTINEL, 0, table.aid // stride)
    minc = _select_by_tag(tag, min_count_in_part)
    keep = (table.aid != SENTINEL) & (table.count >= minc)
    a = jnp.where(keep, table.aid, SENTINEL)
    b = jnp.where(keep, table.aid_next, SENTINEL)
    c = jnp.where(keep, table.count, 0)
    a, b, c = lax.sort((a, b, c), num_keys=2)
    return CountTable(a, b, c, jnp.sum(keep).astype(jnp.int32))


@partial(jax.jit, static_argnums=(2, 3))
def extract_tag(table: CountTable, tag: jnp.ndarray, stride: int,
                capacity: int) -> CountTable:
    """Pull one count type's rows out of a tagged table into an untagged
    CountTable of the given capacity (smallest counts dropped on overflow).
    One compiled program reused for all tags (tag is traced)."""
    in_tag = (table.aid != SENTINEL) & (table.aid // stride == tag)
    a = jnp.where(in_tag, table.aid - tag * stride, SENTINEL)
    b = jnp.where(in_tag, table.aid_next, SENTINEL)
    c = jnp.where(in_tag, table.count, 0)
    a, b, c = lax.sort((a, b, c), num_keys=2)
    n_t = jnp.sum(in_tag).astype(jnp.int32)
    C = capacity

    def trunc(_):
        return _keep_topk_by_count(a, b, c, C)

    def no_trunc(_):
        return a[:C], b[:C], c[:C]

    if table.capacity <= C:
        pad = C - table.capacity
        return CountTable(
            jnp.pad(a, (0, pad), constant_values=int(SENTINEL)),
            jnp.pad(b, (0, pad), constant_values=int(SENTINEL)),
            jnp.pad(c, (0, pad)),
            n_t,
        )
    ak, bk, ck = lax.cond(n_t > C, trunc, no_trunc, None)
    return CountTable(ak, bk, ck, jnp.minimum(n_t, C))


@partial(jax.jit, static_argnums=(1, 2))
def finalize(table: CountTable, min_count: int, max_pairs: int) -> CountTable:
    """Apply the global prune: count >= min_count, keep top max_pairs by count
    (reference: model/count_co_events.py:171-175)."""
    c = jnp.where(table.count >= min_count, table.count, 0)
    a = jnp.where(c > 0, table.aid, SENTINEL)
    b = jnp.where(c > 0, table.aid_next, SENTINEL)
    k = min(max_pairs, table.capacity)
    a, b, c = _keep_topk_by_count(a, b, c, k)
    n = jnp.sum(c > 0).astype(jnp.int32)
    return CountTable(a, b, c, n)


def compress_pairs(
    aid: jnp.ndarray, aid_next: jnp.ndarray, valid: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Map-side combine for a raw pair stream: unique (aid, aid_next) with
    counts. Returns (aid, aid_next, count, n_unique), SENTINEL-padded."""
    ones = jnp.ones_like(aid)
    return seg.sort_compress(aid, aid_next, ones, valid)


# ---------------------------------------------------------------------------
# Host spill store: reference-capacity counting (C7 merge stage).
#
# The device's bounded top table is not sized for the reference's
# up-to-300M-pair matrices (reference: config.py:64
# MAX_CO_EVENT_PAIRS_TO_SAVE; 300M x 5 types x 12 B = 18 GB; whether an
# 80 GB card holds them is ROADMAP D5). The reference solves the same problem
# out-of-core: per-chunk count parquets -> RAM-bounded slice-wise partial
# groupby-sums with MIN_COUNT_IN_PART pruning -> global merge + prune
# (reference: model/count_co_events.py:103-181). Here the device ladder does
# the hot per-microbatch merging (losslessly, up to max_run_rows-row sorted
# runs) and fully-merged top-level runs SPILL to host RAM; the final global
# merge exploits run sortedness (numpy stable sort = timsort, near O(N log k)
# on concatenated sorted runs).
#
# Unlike the reference, the spill path is LOSSLESS until the final prune: no
# in-part min-count is applied, so pairs whose partial counts are each below
# MIN_COUNT_IN_PART but whose global count clears MIN_COUNT_TO_SAVE are KEPT
# (the reference drops them — our retained set is a superset at equal caps).
# ---------------------------------------------------------------------------

import numpy as np  # noqa: E402  (host-side half of this module)

_KK_BITS = 23  # k2 (untagged aid) < 2^23 >= 1.8M OTTO aid space


def _native_kmerge():
    """ctypes handle to the C++ k-way sorted-run merge (native/kmerge.cc),
    or None when the .so isn't built. At reference scale the numpy path
    (stable argsort over ~700M concatenated rows + reduceat) ran ~20 min
    single-core; the streaming loser-tree merge is one O(N log k) pass."""
    global _KMERGE
    if _KMERGE is not None:
        return _KMERGE if _KMERGE is not False else None
    import ctypes
    import os

    so = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)
        ))),
        "native", "libotto_native.so",
    )
    if not os.path.exists(so):
        _KMERGE = False
        return None
    try:
        lib = ctypes.CDLL(so)
        fn = lib.merge2_sum_i64
        p64 = ctypes.POINTER(ctypes.c_int64)
        fn.restype = ctypes.c_int64
        fn.argtypes = [p64, p64, ctypes.c_int64, p64, p64, ctypes.c_int64,
                       p64, p64]
        _KMERGE = fn
        return fn
    except (OSError, AttributeError):  # stale .so without the symbol
        _KMERGE = False
        return None


_KMERGE = None


def _merge_runs_host(runs, n_threads: Optional[int] = None):
    """[(kk sorted int64, count int64), ...] -> (kk, count) groupby-summed.
    C++ pairwise-cascade merge when built, numpy argsort fallback. The
    cascade merges size-balanced pairs (smallest first), so total work is
    ~N log2(k) tight compare-advance steps.

    With >2 runs the cascade rounds run THREADED: pair merges within a
    round are independent, and the ctypes call releases the GIL, so a
    small pool gets real parallelism (otherwise the merge tail is a
    single core against the full spill volume)."""
    fn = _native_kmerge()
    if fn is not None and len(runs) > 1:
        import ctypes

        p64 = ctypes.POINTER(ctypes.c_int64)

        def m2(a, b):
            ka = np.ascontiguousarray(a[0], np.int64)
            ca = np.ascontiguousarray(a[1], np.int64)
            kb = np.ascontiguousarray(b[0], np.int64)
            cb = np.ascontiguousarray(b[1], np.int64)
            out_k = np.empty(len(ka) + len(kb), np.int64)
            out_c = np.empty(len(ka) + len(kb), np.int64)
            n = fn(
                ka.ctypes.data_as(p64), ca.ctypes.data_as(p64), len(ka),
                kb.ctypes.data_as(p64), cb.ctypes.data_as(p64), len(kb),
                out_k.ctypes.data_as(p64), out_c.ctypes.data_as(p64),
            )
            return out_k[:n], out_c[:n]

        if n_threads is None:
            import os

            n_threads = min(2, os.cpu_count() or 1)
        if n_threads > 1 and len(runs) > 2:
            from concurrent.futures import ThreadPoolExecutor

            items = sorted(runs, key=lambda r: len(r[0]))
            with ThreadPoolExecutor(n_threads) as ex:
                while len(items) > 1:
                    pairs = [
                        (items[i], items[i + 1])
                        for i in range(0, len(items) - 1, 2)
                    ]
                    tail = [items[-1]] if len(items) % 2 else []
                    items = list(
                        ex.map(lambda ab: m2(*ab), pairs)
                    ) + tail
                    items.sort(key=lambda r: len(r[0]))
            return items[0]

        import heapq

        # size-ordered pairing keeps the cascade balanced
        heap = [(len(r[0]), i, r) for i, r in enumerate(runs)]
        heapq.heapify(heap)
        nxt = len(runs)
        while len(heap) > 1:
            _, _, a = heapq.heappop(heap)
            _, _, b = heapq.heappop(heap)
            m = m2(a, b)
            heapq.heappush(heap, (len(m[0]), nxt, m))
            nxt += 1
        return heap[0][2]
    kk = np.concatenate([r[0] for r in runs])
    cnt = np.concatenate([r[1] for r in runs])
    order = np.argsort(kk, kind="stable")  # timsort: exploits runs
    kk, cnt = kk[order], cnt[order]
    del order
    first = np.empty(len(kk), bool)
    first[0] = True
    np.not_equal(kk[1:], kk[:-1], out=first[1:])
    idx = np.flatnonzero(first)
    csum = np.add.reduceat(cnt, idx)
    return kk[idx], csum


class HostRunStore:
    """Sorted tagged count runs in host RAM + global merge.

    `merge_every_rows` bounds peak host RAM: once that many un-merged rows
    accumulate, the store compacts itself via merged() (incremental —
    groupby-sum shrinks duplicates away, and the stable argsort is timsort,
    which exploits the already-sorted runs). Without this, a reference-scale
    run (161M train events -> multi-billion raw spilled pairs) holds every
    raw run until finalize and can exhaust even a 125 GB host (measured
    2026-08-20: ~2 GB/min unbounded growth during counting)."""

    def __init__(self, merge_every_rows: int = 256_000_000):
        self._runs: list = []          # (kk int64 sorted, count int64)
        self.rows_spilled = 0
        self.merge_every_rows = int(merge_every_rows)
        self._pending_rows = 0
        self.n_auto_merges = 0

    def add_run(self, k1: np.ndarray, k2: np.ndarray, count: np.ndarray) -> None:
        """Append one compacted run (sorted by (k1, k2), no sentinels)."""
        kk = (k1.astype(np.int64) << _KK_BITS) | k2.astype(np.int64)
        self._runs.append((kk, np.ascontiguousarray(count, np.int64)))
        self.rows_spilled += len(kk)
        self._pending_rows += len(kk)
        if self.merge_every_rows and self._pending_rows >= self.merge_every_rows:
            self._compact()
            self.n_auto_merges += 1

    def _compact(self) -> None:
        """Groupby-sum all stored runs into one sorted run IN PLACE. Unlike
        merged(), no result arrays are built — auto-merges at the default
        256M-row threshold would otherwise allocate and discard multiple GB
        of int32 copies per trigger on an already RAM-pressured host."""
        if len(self._runs) > 1:
            runs, self._runs = self._runs, []
            kk, csum = _merge_runs_host(runs)
            del runs
            self._runs = [(kk, csum)]
        self._pending_rows = 0

    def merged(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Global groupby-sum over all runs -> (k1, k2, count) sorted by
        (k1, k2). The merged result replaces the stored runs, so further
        add_run + merged cycles stay incremental (drain-resume counting)."""
        if not self._runs:
            z = np.zeros(0, np.int64)
            return z.astype(np.int32), z.astype(np.int32), z.astype(np.int32)
        self._compact()
        kk, csum = self._runs[0]
        return (
            (kk >> _KK_BITS).astype(np.int32),
            (kk & ((1 << _KK_BITS) - 1)).astype(np.int32),
            np.minimum(csum, np.iinfo(np.int32).max).astype(np.int32),
        )


def host_finalize(
    aid: np.ndarray, aid_next: np.ndarray, count: np.ndarray,
    min_count: int, max_pairs: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Global prune for one (untagged) count type: count >= min_count, keep
    the top max_pairs by count (reference: model/count_co_events.py:171-179).
    Rows return in (aid, aid_next) order."""
    keep = count >= min_count
    aid, aid_next, count = aid[keep], aid_next[keep], count[keep]
    if len(count) > max_pairs:
        top = np.argsort(-count, kind="stable")[:max_pairs]
        top.sort()  # restore key order
        aid, aid_next, count = aid[top], aid_next[top], count[top]
    return aid, aid_next, count


def host_topn_tables(
    aid: np.ndarray, aid_next: np.ndarray, count: np.ndarray,
    n_aids: int, first_n: int,
):
    """Host-side equivalent of engine.covis.build_retrieval_tables for
    tables too large for one device sort: dense per-aid top-N retrieval
    tables + population-normalized features (reference feature semantics:
    model/retrieve.py:18-63). Returns 5 np arrays [n_aids, first_n]:
    (neighbor, count, count_pop, perc_pop, count_rel).

    The normalized features use the device builder's float32 arithmetic,
    operation for operation, so both builders give identical tables (the
    sharded pipeline builds here, the single-device one on the device)."""
    f32 = np.float32
    total = len(count)
    nbr = np.full((n_aids, first_n), -1, np.int32)
    cnt_t = np.zeros((n_aids, first_n), np.int32)
    cpop_t = np.zeros((n_aids, first_n), np.int32)
    ppop_t = np.zeros((n_aids, first_n), np.int32)
    crel_t = np.zeros((n_aids, first_n), np.int32)
    if total == 0:
        return nbr, cnt_t, cpop_t, ppop_t, crel_t

    # population stats (reference: model/retrieve.py:33-38)
    order_desc = np.argsort(-count, kind="stable")
    rank_of = np.empty(total, np.int64)
    rank_of[order_desc] = np.arange(1, total + 1)
    cmin = int(count[order_desc[-1]])
    q_idx = min(int(f32(total) * f32(1e-4)), total - 1)
    q9999 = int(count[order_desc[q_idx]])
    denom = f32(max(q9999 - cmin, 1))
    count_pop = (
        np.minimum((count - cmin).astype(f32) / denom, f32(1.0)) * f32(10_000)
    ).astype(np.int32)
    perc_pop = (rank_of.astype(f32) / f32(total) * f32(10_000)).astype(np.int32)

    # per-aid top-N by count desc (reference: model/retrieve.py:40-49)
    order = np.lexsort((-count, aid))
    a_s = aid[order]
    starts = np.flatnonzero(np.concatenate([[True], a_s[1:] != a_s[:-1]]))
    start_of_row = np.repeat(starts, np.diff(np.append(starts, len(a_s))))
    rank_in_aid = np.arange(len(a_s)) - start_of_row          # 0-based
    kept = rank_in_aid < first_n
    rows = order[kept]
    a_k, r_k = a_s[kept], rank_in_aid[kept]
    max_per_aid = count[order[start_of_row[kept]]]            # rank-0 count
    nbr[a_k, r_k] = aid_next[rows]
    cnt_t[a_k, r_k] = count[rows]
    cpop_t[a_k, r_k] = count_pop[rows]
    ppop_t[a_k, r_k] = perc_pop[rows]
    crel_t[a_k, r_k] = (
        count[rows].astype(f32) / np.maximum(max_per_aid, 1).astype(f32)
        * f32(100)
    ).astype(np.int32)
    return nbr, cnt_t, cpop_t, ppop_t, crel_t
