"""Co-visitation counting engine (C7).

Drives the device counting pipeline end to end:

  events -> dedup -> length-bucketed padded session tensors
         -> masked pair emission, ONE type-tagged stream  (otto_tpu.ops.pairs)
         -> log-structured merge ladder of sorted runs    (otto_tpu.ops.counts)
         -> bounded top table (per-type in-part pruning)
         -> per-type split -> global prune                (counts.finalize)
         -> dense top-N retrieval tables + features

Replaces the reference's polars self-join + hierarchical parquet merge
(reference: model/count_co_events.py:17-181) and the retrieval-time
feature derivation over count files (reference: model/retrieve.py:18-63).

Design: pair emission is cheap per microbatch, but every sort-merge against
a capacity-C table costs ~C/P times as much as a P-pair microbatch, so the
accumulator must not touch the big table per microbatch. Two changes vs
the naive design:

1. The 5 count types are disjoint in (type_this, type_next)
   (reference: config.py:81-88), so the 5 per-type pair streams collapse
   into ONE stream with the type index packed into the key
   (k1 = type * AID_STRIDE + aid): one sort-merge per step instead of five.
2. Counts accumulate through a log-structured merge ladder: raw microbatch
   streams are STORED (no per-microbatch sort at all); every `arity` runs
   at level k merge losslessly into one level-(k+1) run of capacity
   arity^(k+1) * P. Each pair is sorted only ~log_arity(C/P) times in
   total, vs once against the full table per microbatch. Ladder occupancy
   is the base-`arity` representation of the microbatch counter — pure
   host control flow, no device sync. The top level merges into a bounded
   table with the reference's per-type MIN_COUNT_IN_PART pruning on
   overflow (reference: model/count_co_events.py:152-158, config.py:63).
"""
from __future__ import annotations

import logging
from functools import partial
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from otto_tpu.config import CoVisConfig
from otto_tpu.data.batching import (
    dedup_events,
    iter_filled_microbatches,
    pack_sessions_filled,
)
from otto_tpu.data.schema import Events
from otto_tpu.ops import counts as counts_ops
from otto_tpu.ops import pairs as pairs_ops
from otto_tpu.ops import segment as seg
from otto_tpu.ops.counts import CountTable

log = logging.getLogger(__name__)


class CoVisTables(NamedTuple):
    """Dense per-aid top-N retrieval tables for one count type.

    Feature semantics mirror reference: model/retrieve.py:33-61:
      neighbor    [A, N] int32  top-N aid_next by count desc (-1 pad)
      count       [A, N] int32  raw pair count
      count_pop   [A, N] int32  (count-min)/(q9999-min) clipped *10_000
      perc_pop    [A, N] int32  pair's global rank / total pairs *10_000
      count_rel   [A, N] int32  count / max count over the aid * 100
    The per-aid rank feature is implicit: rank == column index + 1.
    """

    neighbor: jnp.ndarray
    count: jnp.ndarray
    count_pop: jnp.ndarray
    perc_pop: jnp.ndarray
    count_rel: jnp.ndarray


@partial(jax.jit, static_argnums=(1, 2))
def build_retrieval_tables(table: CountTable, n_aids: int, first_n: int) -> CoVisTables:
    """Turn a finalized sparse count table into dense gatherable top-N tables
    (the device analogue of joining count parquets on (aid, aid_next))."""
    aid, aid_next, count = table.aid, table.aid_next, table.count
    valid = (aid != seg.SENTINEL) & (count > 0)
    total = jnp.maximum(jnp.sum(valid), 1)

    # population stats (reference: model/retrieve.py:33-38)
    big = jnp.int32(2**31 - 1)
    cmin = jnp.min(jnp.where(valid, count, big))
    c_desc = -jax.lax.sort(jnp.where(valid, -count, 0))
    q_idx = jnp.clip((total.astype(jnp.float32) * 1e-4).astype(jnp.int32), 0, count.shape[0] - 1)
    q9999 = c_desc[q_idx]
    denom = jnp.maximum(q9999 - cmin, 1).astype(jnp.float32)
    count_pop = (
        jnp.clip((count - cmin).astype(jnp.float32) / denom, None, 1.0) * 10_000
    ).astype(jnp.int32)

    # global percentile rank by count desc (reference: model/retrieve.py:36-37)
    global_rank = seg.ordinal_rank_desc(jnp.zeros_like(aid), count, valid)
    perc_pop = (
        global_rank.astype(jnp.float32) / total.astype(jnp.float32) * 10_000
    ).astype(jnp.int32)

    # per-aid max for count_rel (reference: model/retrieve.py:45-49)
    max_per_aid = jnp.zeros((n_aids + 1,), jnp.int32).at[
        jnp.where(valid, aid, n_aids)
    ].max(count, mode="drop")
    count_rel = (
        count.astype(jnp.float32)
        / jnp.maximum(max_per_aid[jnp.clip(aid, 0, n_aids)], 1).astype(jnp.float32)
        * 100
    ).astype(jnp.int32)

    key = jnp.where(valid, aid, seg.SENTINEL)
    nbr, (cnt_t, cpop_t, ppop_t, crel_t) = seg.build_topn_tables(
        key,
        aid_next,
        (count, count_pop, jnp.where(valid, perc_pop, 0), count_rel),
        n_keys=n_aids,
        n_top=first_n,
        order_by=count,
    )
    return CoVisTables(nbr, cnt_t, cpop_t, ppop_t, crel_t)


# NOTE: no donate_argnums anywhere here — donated-buffer programs missed
# the persistent compilation cache on the runtime this was first built on
# (unchecked on the GPU).
@partial(jax.jit, static_argnums=(0, 1))
def _emit_run_step(
    plan: pairs_ops.CoVisPlan,
    pad_to: int,
    aid: jnp.ndarray,
    ts: jnp.ndarray,
    type_: jnp.ndarray,
    sess: Optional[jnp.ndarray] = None,
) -> CountTable:
    """Emit one microbatch's type-tagged raw pair run (NO sort — the ladder
    sorts `arity` runs at a time). One compiled program per bucket shape.
    `sess` is the lane-wise session id of shelf-packed rows; without it a
    row is one session (legacy single-session packing)."""
    k1, k2, m = pairs_ops.emit_pairs_tagged(
        aid, ts, type_, plan, pad_to=pad_to, sess=sess
    )
    return CountTable(
        aid=jnp.where(m, k1, counts_ops.SENTINEL),
        aid_next=jnp.where(m, k2, counts_ops.SENTINEL),
        count=m.astype(jnp.int32),
        n=jnp.sum(m).astype(jnp.int32),
    )


class _SpillWorker:
    """Background device->host spill executor (one thread).

    Without it the spill path serializes with device counting: each
    top-level run pays its device->host pull plus any host cascade merge
    inline in the ladder's push path, stalling the stream of new
    microbatches. This worker takes the squeezed
    device run and does the pull + HostRunStore.add_run (and the store's
    auto-compaction C++ cascade, which releases the GIL) off-thread while
    the main thread keeps feeding the device.

    max_pending bounds device memory: each pending run holds its device
    arrays alive until pulled, so submit() backpressures by completing the
    oldest pending pull first. Single-writer: only this worker touches the
    store between construction and join()."""

    def __init__(self, store, max_pending: int = 2):
        from concurrent.futures import ThreadPoolExecutor

        self._store = store
        self._ex = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="covis-spill")
        self._pending: list = []
        self.max_pending = max_pending

    def _pull_and_add(self, run: CountTable, n: int) -> None:
        k1 = np.asarray(run.aid)[:n]
        k2 = np.asarray(run.aid_next)[:n]
        c = np.asarray(run.count)[:n]
        self._store.add_run(k1, k2, c)

    def submit(self, run: CountTable, n: int) -> None:
        while len(self._pending) >= self.max_pending:
            self._pending.pop(0).result()  # re-raises worker errors
        self._pending.append(self._ex.submit(self._pull_and_add, run, n))

    def join(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        self.join()
        self._ex.shutdown(wait=True)


class CountLadder:
    """Log-structured merge ladder over fixed-size raw CountTable runs.

    Generic accumulation core shared by CoVisCounter (tagged co-event
    pairs) and PopularityCounter (tagged (cluster, type, recent) x aid
    counts): raw runs of uniform size P are stored unsorted; every `arity`
    runs at level k merge losslessly into one level-(k+1) run of capacity
    arity^(k+1) * P. Fully-merged top-level runs either spill LOSSLESSLY to
    a host store (spill=True) or fold into a bounded device table with
    per-tag in-part min-count overflow pruning (spill=False) — see
    CoVisCounter's docstring for the cost model."""

    def __init__(
        self,
        run_size: int,
        top_capacity: int,
        min_in_part: Tuple[int, ...],
        stride: int,
        arity: int = 4,
        max_run_rows: int = 1 << 25,
        spill: bool = True,
        prune_min_rows: int = 0,
    ):
        self.run_size = run_size
        self.arity = arity
        self.stride = stride
        self._min_in_part = min_in_part
        levels = 0
        while arity ** (levels + 1) * run_size <= max_run_rows:
            levels += 1
        self.n_levels = levels
        self._runs: List[List[Tuple[CountTable, bool]]] = [
            [] for _ in range(levels)
        ]
        self.spill = spill
        self.prune_min_rows = prune_min_rows
        self.rows_pruned = 0
        self._store = counts_ops.HostRunStore() if spill else None
        self._worker = _SpillWorker(self._store) if spill else None
        self._top: CountTable = counts_ops.empty_table(top_capacity)

    # --- device->host spill -------------------------------------------------
    def _spill_run(self, run: CountTable, compacted: bool) -> None:
        """Pull one fully-merged run to the host store (sorted, compacted).

        Runs at or past `prune_min_rows` occupancy first drop pairs below
        their type's in-part min count ON DEVICE (counts_ops.prune_tagged)
        — reference in-part pruning semantics, and the lever that keeps the
        spilled device->host volume proportional to the recurring-pair
        mass, not the singleton tail."""
        if not compacted:  # raw unit-count run: compact on device first
            run = counts_ops.merge_runs_compact_raw((run,))
        if (
            self.prune_min_rows
            and any(m > 1 for m in self._min_in_part)
            and int(run.n) >= self.prune_min_rows
        ):
            before = int(run.n)
            run = counts_ops.prune_tagged(run, self._min_in_part, self.stride)
            self.rows_pruned += before - int(run.n)
        run = self._squeeze(run)
        n = int(run.n)
        if n == 0:
            return
        # hand the squeezed run (capacity <= 2n; host slices to n) to the
        # background worker: the device->host pull + host-store add (and
        # its C++ cascade auto-merges) overlap with continued device
        # counting instead of stalling it.
        self._worker.submit(run, n)
        log.info(
            "covis spill: +%.1fM rows queued (%.1fM spilled so far, "
            "%.1fM pruned)",
            n / 1e6, self._store.rows_spilled / 1e6, self.rows_pruned / 1e6,
        )

    def push(self, run: CountTable) -> None:
        """Add one raw (unsorted, unit-count) run of size run_size."""
        self._push(0, run)

    def push_compacted(self, run: CountTable) -> None:
        """Add one already sort-compressed (front-compacted, aggregated-
        count) run — e.g. a shard-local combine's output."""
        self._push(0, run, compacted=True)

    def _push(self, level: int, run: CountTable, compacted: bool = False) -> None:
        """compacted=True marks merged (front-compacted) runs that still
        need the occupancy squeeze; raw level-0 runs are already size P."""
        if level >= self.n_levels:
            if self.spill:
                self._spill_run(run, compacted)
                return
            self._top = counts_ops.merge_bounded_tagged(
                self._top,
                self._squeeze(run) if compacted else run,
                self._min_in_part,
                self.stride,
            )
            return
        self._runs[level].append((run, compacted))
        if len(self._runs[level]) == self.arity:
            entries, self._runs[level] = self._runs[level], []
            if not any(c for _, c in entries):
                # all-raw (level 0): unit counts — keys-only sort variant
                merged = counts_ops.merge_runs_compact_raw(tuple(
                    r for r, _ in entries
                ))
            else:
                merged = counts_ops.merge_runs_compact(tuple(
                    self._squeeze(r) if c else r for r, c in entries
                ))
            self._push(level + 1, self._lazy_occupancy(merged), compacted=True)

    @staticmethod
    def _lazy_occupancy(t: CountTable) -> CountTable:
        """Schedule the occupancy scalar's device->host transfer WITHOUT
        blocking. The squeeze decision is deferred until the run is
        consumed (arity microbatches later), by which point the transfer
        has long completed — the eager int(t.n) here used to hard-sync the
        whole device queue once per level merge (~21 pipeline bubbles per
        200k-session chunk).

        Memory tradeoff: deferring the squeeze means pending ladder runs
        are held UNSQUEEZED (capacity = sum of input capacities, up to
        arity^k * P each) until consumed — up to ~arity x more device
        memory per pending run than the squeezed form. Still within the
        documented (arity-1) * sum_k arity^k * P worst case; lower
        `max_run_rows` if HBM headroom is tight."""
        try:
            t.n.copy_to_host_async()
        except (AttributeError, NotImplementedError):
            pass  # tracer or backend without async copy: squeeze will sync
        return t

    def _squeeze(self, t: CountTable) -> CountTable:
        """Slice a compacted run down to the smallest power-of-two-of-P size
        holding its uniques. Raw pair grids are ~80-90% padding/invalid
        lanes (dt window + session padding), so without this every ladder
        level sorts mostly dead rows. Occupancy was async-prefetched at
        merge time (_lazy_occupancy), so int() rarely blocks."""
        n = int(t.n)
        size = self.run_size
        while size < n:
            size *= 2
        if size >= t.capacity:
            return t
        return counts_ops.slice_table(t, size)

    def drain(self) -> None:
        """Fold all pending ladder runs into the top table / host store."""
        for level in range(self.n_levels):
            entries, self._runs[level] = self._runs[level], []
            for run, compacted in entries:
                if self.spill:
                    self._spill_run(run, compacted)
                    continue
                self._top = counts_ops.merge_bounded_tagged(
                    self._top,
                    self._squeeze(run) if compacted else run,
                    self._min_in_part,
                    self.stride,
                )

    def host_merged(self):
        """(k1, k2, count) host arrays, globally merged (spill mode)."""
        assert self.spill
        self.drain()
        self._worker.join()  # all pending pulls land before the global merge
        return self._store.merged()


class CoVisCounter:
    """Stateful device-side counter over streamed event chunks.

    `capacity` is PER COUNT TYPE (the bounded top table holds
    capacity * n_types tagged rows — memory parity with the previous
    5-separate-tables design). `pair_budget` P is the uniform raw-run size;
    `arity` the ladder fan-in. Losslessness: level-k runs hold the pairs of
    arity^k microbatches and have capacity arity^k * P >= their uniques, so
    truncation can only happen at the bounded top (explicit, with reference
    MIN_COUNT_IN_PART semantics) — never inside the ladder."""

    def __init__(
        self,
        cfg: CoVisConfig,
        capacity: Optional[int] = None,
        pair_budget: Optional[int] = None,
        # True: fully-merged top-level runs spill LOSSLESSLY to host RAM and
        # the global merge happens there (reference-capacity semantics: the
        # 300M-pair matrices are held out of core, as the reference holds
        # them, model/count_co_events.py:103-181; ROADMAP D5). False:
        # device-only bounded top table with in-part overflow pruning.
        # None: cfg.host_spill.
        spill: Optional[bool] = None,
        # with shelf packing, lanes/event ~= L / row-fill: favor SMALL row
        # lengths. Pair volume is QUADRATIC in session length, so the rare
        # mid/long sessions dominate lane volume and deserve fine bucket
        # granularity: rounding a length-l class up to the next power of two
        # costs up to 4x lanes ((2l)^2/l^2), measured 25% of total volume at
        # OTTO-like length skew. Each bucket costs one emit-program compile
        # (cached persistently); ladder merge programs are shared (uniform
        # pad_to). Real OTTO p99 ~38 unique aids, reference README.md:18.
        bucket_lens: Sequence[int] = (
            8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 512
        ),
        arity: int = 4,
        max_run_rows: Optional[int] = None,
    ):
        self.cfg = cfg
        self.plan = pairs_ops.make_plan(cfg)
        if not pairs_ops.plan_types_disjoint(self.plan):
            raise ValueError(
                "count types overlap in (type_this, type_next); tagged "
                "single-stream counting requires disjoint types"
            )
        self.n_types = len(cfg.names)
        self.per_type_capacity = capacity or cfg.accumulator_capacity
        self.capacity = self.per_type_capacity * self.n_types
        pair_budget = pair_budget or getattr(cfg, "pair_budget", 1 << 22)
        max_run_rows = max_run_rows or getattr(cfg, "max_run_rows", 1 << 26)
        self.pair_budget = pair_budget
        self.bucket_lens = tuple(bucket_lens)
        self.arity = arity
        self.spill = (
            getattr(cfg, "host_spill", False) if spill is None else spill
        )
        # ladder height: every extra level strictly reduces amortized sort
        # volume (level merges cost ~2P rows/microbatch each; the top merge
        # costs 2*(C + arity^K*P)/arity^K, shrinking as K grows), so K is
        # bounded only by run MEMORY: pending runs total
        # ~(arity-1) * sum_k arity^k * P rows. max_run_rows (default 32M
        # rows = 384 MB at 12 B/row) caps the largest run.
        self._ladder = CountLadder(
            run_size=pair_budget,
            top_capacity=self.capacity,
            min_in_part=tuple(
                max(1, cfg.min_count_in_part.get(name, 1))
                for name in cfg.names
            ),
            stride=pairs_ops.AID_STRIDE,
            arity=arity,
            max_run_rows=max_run_rows,
            spill=self.spill,
            prune_min_rows=getattr(cfg, "spill_prune_min_rows", 0),
        )

    @property
    def n_levels(self) -> int:
        return self._ladder.n_levels

    @property
    def _store(self):
        return self._ladder._store

    def update(self, events: Events) -> None:
        """Count all co-event pairs in a chunk of sessions. Sessions must be
        complete within the chunk (chunking is by session, as in reference:
        model/count_co_events.py:83).

        Rows are SHELF-PACKED (several whole sessions per row, lane-wise
        session-id mask): single-session rows leave [S, L, L] pair grids
        85-95% dead lanes at OTTO session lengths, and lanes — valid or
        not — are what the emit pass and the ladder's level-0 sorts pay
        for. Pair semantics are unchanged (tests: chunked == one-shot ==
        reference-semantics oracle)."""
        ev = dedup_events(events)
        for filled in pack_sessions_filled(ev, self.bucket_lens):
            L = filled.max_len
            s_batch = pairs_ops.pair_budget_sessions(L, self.pair_budget)
            n_mb = -(-filled.n_rows // s_batch)
            log.info(
                "covis bucket L=%d: %d rows, %d microbatches (%.0fM lanes)",
                L, filled.n_rows, n_mb, filled.n_rows * L * L / 1e6,
            )
            for mb in iter_filled_microbatches(filled, s_batch):
                run = _emit_run_step(
                    self.plan,
                    self.pair_budget,
                    jnp.asarray(mb.aid),
                    jnp.asarray(mb.ts),
                    jnp.asarray(mb.type),
                    jnp.asarray(mb.sess),
                )
                self._ladder.push(run)

    @property
    def tables(self) -> Dict[str, CountTable]:
        """Per-type untagged count tables. Device mode: capacity =
        per_type_capacity. Spill mode: numpy-backed CountTables of exact
        occupancy (host RAM is the capacity bound, as in the reference)."""
        out: Dict[str, CountTable] = {}
        if self.spill:
            k1, k2, cnt = self._ladder.host_merged()
            stride = pairs_ops.AID_STRIDE
            for i, name in enumerate(self.cfg.names):
                lo, hi = np.searchsorted(k1, [i * stride, (i + 1) * stride])
                out[name] = CountTable(
                    aid=k1[lo:hi] - np.int32(i * stride),
                    aid_next=k2[lo:hi],
                    count=cnt[lo:hi],
                    n=np.int32(hi - lo),
                )
            return out
        self._ladder.drain()
        for i, name in enumerate(self.cfg.names):
            out[name] = counts_ops.extract_tag(
                self._ladder._top,
                jnp.int32(i),
                pairs_ops.AID_STRIDE,
                self.per_type_capacity,
            )
        return out

    def finalize(self) -> Dict[str, CountTable]:
        """Global prune per count type (reference: model/count_co_events.py:171-175)."""
        out = {}
        for name, t in self.tables.items():
            min_c = self.cfg.min_count_to_save.get(name, 1)
            if self.spill:
                a, b, c = counts_ops.host_finalize(
                    t.aid, t.aid_next, t.count, min_c, self.cfg.max_pairs_to_save
                )
                out[name] = CountTable(a, b, c, np.int32(len(a)))
            else:
                out[name] = counts_ops.finalize(
                    t, min_c, self.cfg.max_pairs_to_save
                )
        return out

    def retrieval_tables(
        self, n_aids: int, device_topn_max_rows: int = 1 << 26
    ) -> Dict[str, CoVisTables]:
        final = self.finalize()
        out = {}
        for name in self.cfg.names:
            first_n = self.cfg.retrieval_first_n[name]
            t = final[name]
            if self.spill:
                n = int(t.n)
                if 0 < n <= device_topn_max_rows:
                    # push the pruned host table back to the device and
                    # build dense tables there: the per-type host lexsorts
                    # were minutes of the reference-scale covis tail, the
                    # device sort is sub-second (pad to pow2 => few shapes)
                    size = max(1024, 1 << (n - 1).bit_length())
                    pad = size - n

                    def _pad(x, fill):
                        return jnp.asarray(np.pad(
                            np.asarray(x), (0, pad), constant_values=fill
                        ))

                    td = CountTable(
                        _pad(t.aid, int(seg.SENTINEL)),
                        _pad(t.aid_next, int(seg.SENTINEL)),
                        _pad(t.count, 0),
                        jnp.int32(n),
                    )
                    out[name] = build_retrieval_tables(td, n_aids, first_n)
                else:
                    out[name] = CoVisTables(*(
                        jnp.asarray(a) for a in counts_ops.host_topn_tables(
                            np.asarray(t.aid), np.asarray(t.aid_next),
                            np.asarray(t.count), n_aids, first_n,
                        )
                    ))
            else:
                out[name] = build_retrieval_tables(t, n_aids, first_n)
        return out


class ShardedCoVisCounter:
    """Multi-device counting: sessions data-parallel over a mesh axis, the
    type-tagged count table row-sharded by aid ownership, all-to-all count
    exchange per microbatch (parallel/collectives.py — the SPMD form of the
    reference's chunked count + hierarchical merge,
    model/count_co_events.py:80-181, with device collectives replacing Dask
    shuffles per SURVEY.md §5.8). finalize()/retrieval_tables() pull the
    sharded table once and reuse the host-side prune + dense-table builders,
    so the output contract matches CoVisCounter exactly."""

    def __init__(
        self,
        cfg: CoVisConfig,
        mesh_ctx,                       # parallel.mesh.MeshContext
        capacity_per_shard: Optional[int] = None,
        pair_budget: int = 1 << 21,
        bucket_lens: Sequence[int] = (8, 16, 24, 32, 48, 64, 96, 128, 192,
                                      256, 512),
    ):
        from otto_tpu.parallel.collectives import (
            make_sharded_covis_update,
            make_sharded_table,
        )

        self.cfg = cfg
        self.plan = pairs_ops.make_plan(cfg)
        self.mesh_ctx = mesh_ctx
        self.axis = mesh_ctx.data_axis
        self.n_shards = mesh_ctx.mesh.shape[self.axis]
        self.bucket_lens = tuple(bucket_lens)
        self.pair_budget = pair_budget
        cap = capacity_per_shard or max(
            1 << 16, cfg.accumulator_capacity // self.n_shards
        )
        self._update = make_sharded_covis_update(
            self.plan, mesh_ctx.mesh, axis=self.axis
        )
        self._table = make_sharded_table(cap, mesh_ctx.mesh, axis=self.axis)

    def update(self, events: Events) -> None:
        ev = dedup_events(events)
        for filled in pack_sessions_filled(ev, self.bucket_lens):
            L = filled.max_len
            s_batch = pairs_ops.pair_budget_sessions(L, self.pair_budget)
            # microbatch rows must divide evenly across shards
            s_batch = max(self.n_shards, (s_batch // self.n_shards) * self.n_shards)
            for mb in iter_filled_microbatches(filled, s_batch):
                self._table = self._update(
                    self._table,
                    jnp.asarray(mb.aid),
                    jnp.asarray(mb.ts),
                    jnp.asarray(mb.type),
                    jnp.asarray(mb.sess),
                )

    def host_tables(self) -> Dict[str, Tuple]:
        """Pull the sharded table once: {name: (aid, aid_next, count)}."""
        from otto_tpu.parallel.collectives import gather_tagged_table

        return gather_tagged_table(self._table, self.cfg.names)

    def finalize(self) -> Dict[str, CountTable]:
        out = {}
        for name, (a, b, c) in self.host_tables().items():
            a2, b2, c2 = counts_ops.host_finalize(
                a, b, c,
                self.cfg.min_count_to_save.get(name, 1),
                self.cfg.max_pairs_to_save,
            )
            out[name] = CountTable(a2, b2, c2, np.int32(len(a2)))
        return out

    def retrieval_tables(self, n_aids: int) -> Dict[str, CoVisTables]:
        final = self.finalize()
        return {
            name: CoVisTables(*(
                jnp.asarray(x) for x in counts_ops.host_topn_tables(
                    np.asarray(t.aid), np.asarray(t.aid_next),
                    np.asarray(t.count), n_aids,
                    self.cfg.retrieval_first_n[name],
                )
            ))
            for name, t in final.items()
        }


def count_events(
    events: Events,
    cfg: CoVisConfig,
    capacity: Optional[int] = None,
    min_count_override: Optional[int] = None,
) -> Dict[str, CountTable]:
    """One-shot convenience: count an entire event table."""
    counter = CoVisCounter(cfg, capacity=capacity)
    counter.update(events)
    if min_count_override is None:
        return counter.finalize()
    return {
        name: counts_ops.finalize(t, min_count_override, cfg.max_pairs_to_save)
        for name, t in counter.tables.items()
    }
