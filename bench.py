"""Headline benchmark: end-to-end retrieval throughput per chip.

Measures steady-state sessions/second through the fused multi-source
retrieval + feature engine (C13, the reference's 40-minute stage for 1.67M
sessions => ~700 sessions/s on the baseline CPU box, reference:
model/retrieve.py:670 / BASELINE.md). Prints ONE JSON line.

Env knobs: OTTO_BENCH_SESSIONS (default 20000), OTTO_BENCH_AIDS (50000).
Exits non-zero without a GPU: a CPU timing is not a device measurement.
"""
import json
import os
import sys
import time

import numpy as np

BASELINE_SESSIONS_PER_S = 1_670_000 / (40 * 60)  # reference retrieval stage


def main() -> int:
    import jax
    import jax.numpy as jnp

    from otto_tpu.config import (
        CoVisConfig,
        RetrievalConfig,
        enable_persistent_compilation_cache,
    )

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}", file=sys.stderr)
        return 2
    enable_persistent_compilation_cache()
    from otto_tpu.data.batching import iter_microbatches, pack_sessions
    from otto_tpu.data.split import split_events
    from otto_tpu.data.synthetic import SyntheticSpec, generate
    from otto_tpu.engine.covis import CoVisCounter
    from otto_tpu.engine.retrieval import RetrievalContext, retrieve_batch

    n_sessions = int(os.environ.get("OTTO_BENCH_SESSIONS", 20_000))
    n_aids = int(os.environ.get("OTTO_BENCH_AIDS", 50_000))
    batch_s = int(os.environ.get("OTTO_BENCH_BATCH", 512))

    t0 = time.time()
    spec = SyntheticSpec(
        n_sessions=n_sessions, n_aids=n_aids, mean_len=12, span_days=21, seed=7
    )
    ev = generate(spec)
    sp = split_events(ev, test_days=7, seed=0)
    print(f"# data {time.time()-t0:.1f}s", file=sys.stderr)

    # real co-visitation tables from the data (density matters for gathers);
    # single bucket => one compiled counting program.
    # spill=False: bench-scale counts fit the device bounded table.
    # Compile vs steady-state split: the first counting pass pays any cold
    # compilation; a second pass over the same data through a FRESH counter
    # reuses every compiled program and measures the stage cost.
    def build_counter():
        return CoVisCounter(
            CoVisConfig(), capacity=1 << 20, pair_budget=1 << 20,
            bucket_lens=(64,), spill=False,
        )

    t = time.time()
    counter = build_counter()
    counter.update(sp.train)
    counter.retrieval_tables(n_aids)
    print(f"# covis cold (incl. compile) {time.time()-t:.1f}s", file=sys.stderr)
    t = time.time()
    counter = build_counter()
    counter.update(sp.train)
    tables = counter.retrieval_tables(n_aids)
    print(f"# covis steady {time.time()-t:.1f}s", file=sys.stderr)
    print(f"# covis {time.time()-t0:.1f}s", file=sys.stderr)

    # synthetic-but-dense aux tables (w2v knn, popularity, embeddings)
    rng = np.random.default_rng(0)
    k = 20
    knn_nbr = rng.integers(0, n_aids, (n_aids, k)).astype(np.int32)
    knn_dist = rng.random((n_aids, k)).astype(np.float32)
    pop_cand = rng.integers(0, n_aids, (50, 128)).astype(np.int32)
    pop_ranks = rng.integers(1, 999, (50, 128, 6)).astype(np.int32)
    cl1 = rng.integers(1, 999, (n_aids, 6)).astype(np.int32)
    aid_emb = rng.normal(size=(n_aids, 100)).astype(np.float32)

    cfg = RetrievalConfig()
    ctx = RetrievalContext(
        covis=tuple(tables[n] for n in CoVisConfig().names),
        knn_all=(jnp.asarray(knn_nbr), jnp.asarray(knn_dist)),
        knn_1_2=(jnp.asarray(knn_nbr), jnp.asarray(knn_dist)),
        pop_cl50_cand=jnp.asarray(pop_cand),
        pop_cl50_ranks=jnp.asarray(pop_ranks),
        pop_cl1_rank=jnp.asarray(cl1),
        aid_emb=jnp.asarray(aid_emb),
    )
    trim = jnp.asarray([20.0, 3.0, 17.0 / 29.0], jnp.float32)

    # realistic length-bucketing: short sessions (the vast majority) run
    # through much smaller fan-out grids
    packs = pack_sessions(sp.test, bucket_lens=(8, 64))
    jobs = []  # (padded microbatches, bucket length)
    for p in packs:
        mbs = list(iter_microbatches(p, batch_s))
        jobs.append(mbs)
        print(f"# bucket L={p.max_len}: {p.n_sessions} sessions, "
              f"{len(mbs)} batches", file=sys.stderr)

    # constant across batches: kept out of the timed loop
    cluster = jnp.zeros((batch_s,), jnp.int32)
    semb = jnp.zeros((batch_s, 100), jnp.float32)

    def run_one(mb):
        return retrieve_batch(
            (jnp.asarray(mb.aid), jnp.asarray(mb.ts), jnp.asarray(mb.type)),
            ctx, cluster, semb, trim,
            cfg.max_session_aids, cfg.max_candidates,
        )

    # warmup / compile each bucket shape
    for mbs in jobs:
        jax.block_until_ready(run_one(mbs[0]))
    print(f"# compiled {time.time()-t0:.1f}s", file=sys.stderr)

    n_measured = 0
    t = time.time()
    out = None
    for mbs in jobs:
        for mb in mbs:
            out = run_one(mb)
            n_measured += int((mb.session >= 0).sum())
    # the device runs one program at a time, in dispatch order
    jax.block_until_ready(out)
    dt = time.time() - t

    sessions_per_s = n_measured / dt
    print(
        json.dumps(
            {
                "metric": "retrieval_sessions_per_s",
                "value": round(sessions_per_s, 1),
                "unit": "sessions/s",
                "vs_baseline": round(sessions_per_s / BASELINE_SESSIONS_PER_S, 2),
                "device": {"platform": dev.platform, "kind": dev.device_kind,
                           "count": len(jax.devices())},
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
