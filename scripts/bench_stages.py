"""Per-stage throughput benchmark suite (one JSON line per stage).

bench.py measures the headline (retrieval sessions/s); this covers every
other heavy stage against the reference's self-logged wall clocks on its
12.9M-session / 220M-event dataset (BASELINE.md "Throughput" table):

  stage            reference                      baseline rate
  covis            220M events, 20+30 min         73.3k events/s (count+merge)
  w2vec SGNS       ~5 epochs x 220M positions,    ~426k positions/s
                   43 min (big model, 16 threads)
  kNN              faiss IVF 1400->380 aids/s     1400 queries/s (lossy IVF;
                                                  ours is exact)
  session emb      12.9M sessions, ~12 min        17.9k sessions/s
  kmeans           12.9M x 100, k=50, <=100 it,   ~896k point-iters/s
                   24 min
  popularity       220M events, ~10 min           367k events/s
  gbdt train       3 models x 150 trees over      ~1.2M row-trees/s
                   40M/11M/7.5M rows, 5-10 min
  scoring          1.67M sessions x ~172 cands    ~239k scored rows/s
                   x 3 models, ~60 min

Every timing ends in jax.block_until_ready, warmup (compile) excluded.
Roofline columns divide by the peaks of the device it ran on (PEAKS,
keyed by device_kind); a device not in the table is an error.

Usage: python scripts/bench_stages.py
Env: OTTO_STAGEBENCH_SESSIONS (default 200000), OTTO_STAGEBENCH_AIDS (100000)
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# Published dense peaks by jax device_kind, at the card's full power limit
# (source: NVIDIA H100 SXM data sheet, 700 W, rates without sparsity):
# bf16 tensor cores, f32 outside the tensor cores, device-memory bandwidth.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12, "f32_flops": 67e12, "mem_bps": 3.35e12,
    },
}


def device_peaks(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       "add its row to PEAKS with its source")
    return PEAKS[device_kind]


PEAK = {}  # set in main() from the device the run is on


def emit(stage, value, unit, baseline, *, wall_s=None, flops=None,
         bytes_moved=None, peak="bf16_flops"):
    """flops/bytes_moved are per-run ANALYTIC totals (formula at the call
    site); with wall_s they yield achieved TFLOP/s / GB/s and a
    %-of-roofline column (SURVEY §5.1 roofline accounting)."""
    row = {
        "metric": stage,
        "value": round(value, 1),
        "unit": unit,
        "vs_baseline": round(value / baseline, 2) if baseline else None,
    }
    if wall_s:
        if flops is not None:
            row["achieved_tflops"] = round(flops / wall_s / 1e12, 2)
            row["pct_of_flops_roofline"] = round(
                100 * flops / wall_s / PEAK[peak], 1)
        if bytes_moved is not None:
            row["achieved_gbps"] = round(bytes_moved / wall_s / 1e9, 1)
            row["pct_of_mem_roofline"] = round(
                100 * bytes_moved / wall_s / PEAK["mem_bps"], 1)
    print(json.dumps(row), flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from otto_tpu.config import (
        CoVisConfig, GBDTConfig, PopularityConfig, Word2VecConfig,
        enable_persistent_compilation_cache,
    )
    from otto_tpu.data.batching import pack_sessions
    from otto_tpu.data.split import split_events
    from otto_tpu.data.synthetic import SyntheticSpec, generate
    from otto_tpu.engine.covis import CoVisCounter
    from otto_tpu.engine.popularity import compute_popularity
    from otto_tpu.engine.session_embed import session_embedding_batch
    from otto_tpu.models.word2vec import (
        build_vocab, init_params, make_neg_cdf, sgns_epoch_device,
    )
    from otto_tpu.ops.kmeans import kmeans_fit
    from otto_tpu.ops.knn import knn_search

    dev = jax.devices()[0]
    PEAK.update(device_peaks(dev.device_kind))
    print(f"# device {dev.device_kind} x{len(jax.devices())}", file=sys.stderr)
    enable_persistent_compilation_cache()

    NS = int(os.environ.get("OTTO_STAGEBENCH_SESSIONS", 200_000))
    NA = int(os.environ.get("OTTO_STAGEBENCH_AIDS", 100_000))
    skip = set(os.environ.get("OTTO_STAGEBENCH_SKIP", "").split(","))

    def should(name: str) -> bool:
        return name not in skip

    t0 = time.time()
    ev = generate(SyntheticSpec(
        n_sessions=NS, n_aids=NA, mean_len=12, span_days=21, seed=7))
    print(f"# data: {len(ev)} events {time.time()-t0:.0f}s", file=sys.stderr)

    # ---- covis counting (C7): count+merge fused ----------------------------
    if should("covis"):
        def covis_run():
            c = CoVisCounter(CoVisConfig())
            c.update(ev)
            # retrieval_tables forces the final merge; time must include it
            c.retrieval_tables(NA)
        covis_run()                                # warmup/compile
        t = time.time()
        covis_run()
        wall = time.time() - t
        # sort-bound: emitted grid lanes ride ~4 sort passes of 2 i32
        # operands, read+write (ladder levels + top merge)
        from otto_tpu.data.batching import dedup_events, pack_sessions_filled
        lanes = sum(f.n_rows * f.max_len ** 2
                    for f in pack_sessions_filled(dedup_events(ev),
                                                  CoVisCounter(CoVisConfig()).bucket_lens))
        emit("covis_events_per_s", len(ev) / wall, "events/s",
             220e6 / (50 * 60), wall_s=wall,
             bytes_moved=lanes * 4 * 2 * 2 * 4)

    # ---- w2vec SGNS (C8) ----------------------------------------------------
    if should("sgns"):
        from otto_tpu.models.word2vec import (
            _NEG_CHUNK,
            flat_corpus,
            make_alias,
            pack_position_info,
            sgns_epoch_device_block,
        )

        cfg = Word2VecConfig()
        vocab = build_vocab(ev, cfg.types, cfg.min_count, NA)
        comp, cum = flat_corpus(ev, vocab, cfg.types)
        freq = vocab.counts / max(vocab.counts.sum(), 1)
        keep_prob = np.minimum(
            1.0, np.sqrt(cfg.subsample_t / np.maximum(freq, 1e-12))
            + cfg.subsample_t / np.maximum(freq, 1e-12)).astype(np.float32)
        # embedding tables at PRODUCTION row count (V=1.73M for the big
        # w2v-all model at reference scale): the tables' row space sets
        # the gather/scatter cost. Sampled ids stay
        # within the bench vocab; the tail rows are cold, as the production
        # vocab's unsampled tail is.
        prod_rows = max(vocab.size,
                        int(os.environ.get("OTTO_BENCH_W2V_ROWS", 1_733_412)))
        params = init_params(prod_rows, cfg.vector_size, cfg.seed)
        prob_np, alias_np = make_alias(vocab.counts, cfg.ns_exponent)
        prob_a = np.zeros(prod_rows, np.float32)
        alias_a = np.zeros(prod_rows, np.int32)
        prob_a[: vocab.size], alias_a[: vocab.size] = prob_np, alias_np
        kp = np.zeros(prod_rows, np.float32)
        kp[: vocab.size] = keep_prob
        k = max(2, cfg.block_k)
        cpc = max(1, _NEG_CHUNK // k)
        n_centers = -(-(cfg.batch_size // k) // cpc) * cpc
        # alias draws index the full [prod_rows] table; restrict the draw
        # space to the populated vocab by scaling j's range via prob/alias
        # content (tail prob rows are 0 -> alias target 0, harmless)
        args = (jnp.asarray(comp), jnp.asarray(pack_position_info(cum)),
                jnp.asarray(prob_a[: vocab.size]),
                jnp.asarray(alias_a[: vocab.size]),
                jnp.asarray(kp), jnp.float32(cfg.learning_rate))
        STEPS = 64
        key = jax.random.PRNGKey(0)
        _, l = sgns_epoch_device_block(
            params, *args, n_centers, k, cfg.window, cfg.negatives, STEPS,
            key, "adagrad",
        )
        jax.block_until_ready(l)
        t = time.time()
        _, l = sgns_epoch_device_block(
            params, *args, n_centers, k, cfg.window, cfg.negatives, STEPS,
            key, "adagrad",
        )
        jax.block_until_ready(l)
        wall = time.time() - t
        pairs = n_centers * k * STEPS
        # negative tower einsums: 3 matmul passes x 2 flops over the pair
        # and pooled-negative logits
        flops = 3 * 2 * pairs * cfg.padded_dim * (1 + cfg.negatives)
        emit("sgns_pairs_per_s", pairs / wall,
             "pairs/s", 426_000, wall_s=wall, flops=flops)

    # ---- exact kNN (C9) ----------------------------------------------------
    if should("knn"):
        emb = np.random.default_rng(4).normal(
            size=(NA, 100)).astype(np.float32)
        nq = min(NA, 65536)
        knn_search(emb[:256], emb, 20, metric="l2")    # warmup small+full shapes
        knn_search(emb[:nq], emb, 20, metric="l2")
        t = time.time()
        knn_search(emb[:nq], emb, 20, metric="l2")
        wall = time.time() - t
        emit("knn_queries_per_s", nq / wall, "queries/s", 1400,
             wall_s=wall, flops=2 * nq * NA * emb.shape[1],
             peak="f32_flops")

    # ---- session embeddings (C10) -------------------------------------------
    if should("session_emb"):
        table = jnp.asarray(np.random.default_rng(0).normal(
            size=(NA, 100)).astype(np.float32))
        packs = pack_sessions(ev, bucket_lens=(8, 64))
        for p in packs:                                # warmup both buckets
            jax.block_until_ready(session_embedding_batch(
                jnp.asarray(p.aid), jnp.asarray(p.ts), jnp.asarray(p.type), table))
        t = time.time()
        n = 0
        out = None
        for p in packs:
            out = session_embedding_batch(
                jnp.asarray(p.aid), jnp.asarray(p.ts), jnp.asarray(p.type), table)
            n += p.n_sessions
        jax.block_until_ready(out)
        wall = time.time() - t
        # gather-bound: one [D] f32 table row + weights per event lane
        lanes = sum(p.aid.size for p in packs)
        emit("session_emb_sessions_per_s", n / wall, "sessions/s",
             12.9e6 / (12 * 60), wall_s=wall,
             bytes_moved=lanes * (100 * 4 + 12))

    # ---- kmeans (C11) --------------------------------------------------------
    if should("kmeans"):
        x = np.asarray(jnp.asarray(np.random.default_rng(1).normal(
            size=(min(NS, 500_000), 100)).astype(np.float32)))
        kmeans_fit(x, 50, max_iter=3, tol=0.0, seed=0)  # warmup
        # reference budget: <=100 Lloyd iterations (model/kmeans_sessions.py:
        # 147, its 896k pt-it/s assumes the full 100). Host->device upload is
        # included, mirroring the reference's HDF5 read.
        t = time.time()
        iters = 100
        kmeans_fit(x, 50, max_iter=iters, tol=0.0, seed=0)
        wall = time.time() - t
        emit("kmeans_point_iters_per_s", len(x) * iters / wall,
             "point-iters/s", 896_000, wall_s=wall,
             flops=2 * len(x) * 50 * x.shape[1] * iters,
             peak="f32_flops")

    # ---- popularity (C12) ----------------------------------------------------
    if should("popularity"):
        clusters = np.random.default_rng(2).integers(
            0, 50, len(ev)).astype(np.int32)
        pcfg = PopularityConfig()
        compute_popularity(ev, clusters, 50, NA, pcfg)  # warmup
        t = time.time()
        compute_popularity(ev, clusters, 50, NA, pcfg)
        wall = time.time() - t
        # sort-bound: ~3 sort passes of ~6 i32 columns, read+write
        emit("popularity_events_per_s", len(ev) / wall, "events/s",
             220e6 / (10 * 60), wall_s=wall,
             bytes_moved=len(ev) * 6 * 4 * 3 * 2)

    # ---- gbdt train + scoring (C16, C17) --------------------------------------
    if should("gbdt"):
        from otto_tpu.models.gbdt import (
            _predict_binned_program, _train_program, bin_features,
            compute_bin_edges,
        )
        gcfg = GBDTConfig()
        NG, G, F = 1 << 14, 96, 104
        rng = np.random.default_rng(3)
        bins = jnp.asarray(rng.integers(0, gcfg.n_bins, (NG * G, F)).astype(np.uint8))
        labels = jnp.asarray((rng.random((NG, G)) < 0.05).astype(np.float32))
        mask = jnp.asarray(rng.random((NG, G)) < 0.8)
        tids = jnp.arange(gcfg.trees_per_dispatch)
        z = jnp.zeros(NG * G, jnp.float32)
        out = _train_program(bins, labels, mask, gcfg, scores0=z, tree_ids=tids)
        jax.block_until_ready(out)
        t = time.time()
        out = _train_program(bins, labels, mask, gcfg, scores0=z, tree_ids=tids)
        jax.block_until_ready(out)
        wall = time.time() - t
        # bf16 matmul work per tree: histogram einsum N x Fs x n_bins x (W*3)
        # per level + the one-hot column-subsample matmul N x F x Fs
        T, N = gcfg.trees_per_dispatch, NG * G
        Fs = max(1, int(round(gcfg.colsample * F)))
        W = 1 << (gcfg.max_depth - 1)
        flops = T * (gcfg.max_depth * 2 * N * Fs * gcfg.n_bins * W * 3
                     + 2 * N * F * Fs)
        emit("gbdt_train_row_trees_per_s", N * T / wall,
             "row-trees/s", 1.2e6, wall_s=wall, flops=flops)

        gfeat, thr, _gain, leaf, _scores = out
        sc = _predict_binned_program(bins, gfeat, thr, leaf, gcfg.n_bins)
        jax.block_until_ready(sc)
        t = time.time()
        sc = _predict_binned_program(bins, gfeat, thr, leaf, gcfg.n_bins)
        jax.block_until_ready(sc)
        wall = time.time() - t
        # gather/select-bound: per level one [M, F] uint8 bin read + the
        # [M, T] i32 node state read+write
        M, T = NG * G, gfeat.shape[0]
        emit("gbdt_score_rows_per_s", M / wall, "rows/s", 239_000,
             wall_s=wall,
             bytes_moved=gcfg.max_depth * (M * F + M * T * 4 * 2))

    print(f"# total {time.time()-t0:.0f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
