"""Stage-level profiling of retrieve_batch on the card.

Uses the `_stop_after` hook to time cumulative prefixes (fanout -> l1 ->
l2 -> compact -> full) and prints the per-stage deltas for one bucket
shape.

Usage: OTTO_PROF_L=64 OTTO_PROF_S=512 python scripts/profile_retrieval.py
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
import jax.numpy as jnp

from otto_tpu.config import (
    CoVisConfig,
    RetrievalConfig,
    enable_persistent_compilation_cache,
)
from otto_tpu.data.batching import iter_microbatches, pack_sessions
from otto_tpu.data.split import split_events
from otto_tpu.data.synthetic import SyntheticSpec, generate
from otto_tpu.engine.covis import CoVisCounter
from otto_tpu.engine.retrieval import RetrievalContext, retrieve_batch
from otto_tpu.engine import retrieval as R

S = int(os.environ.get("OTTO_PROF_S", 512))
L = int(os.environ.get("OTTO_PROF_L", 64))
N_AIDS = int(os.environ.get("OTTO_PROF_AIDS", 50_000))
REPS = int(os.environ.get("OTTO_PROF_REPS", 5))


def main():
    enable_persistent_compilation_cache()
    spec = SyntheticSpec(
        n_sessions=20_000, n_aids=N_AIDS, mean_len=12, span_days=21, seed=7
    )
    ev = generate(spec)
    sp = split_events(ev, test_days=7, seed=0)
    counter = CoVisCounter(
        CoVisConfig(), capacity=1 << 20, pair_budget=1 << 20, bucket_lens=(L,)
    )
    counter.update(sp.train)
    tables = counter.retrieval_tables(N_AIDS)
    print(f"# covis built", file=sys.stderr)

    cfg = RetrievalConfig()
    rng = np.random.default_rng(0)
    D = 32
    ctx = RetrievalContext(
        covis=tuple(tables[n] for n in CoVisConfig().names),
        knn_all=(
            jnp.asarray(rng.integers(-1, N_AIDS, (N_AIDS, 20)).astype(np.int32)),
            jnp.asarray(rng.random((N_AIDS, 20)).astype(np.float32)),
        ),
        knn_1_2=(
            jnp.asarray(rng.integers(-1, N_AIDS, (N_AIDS, 20)).astype(np.int32)),
            jnp.asarray(rng.random((N_AIDS, 20)).astype(np.float32)),
        ),
        pop_cl50_cand=jnp.asarray(
            rng.integers(0, N_AIDS, (50, 126)).astype(np.int32)
        ),
        pop_cl50_ranks=jnp.asarray(
            rng.integers(1, 999, (50, 126, 6)).astype(np.int32)
        ),
        pop_cl1_rank=jnp.asarray(
            rng.integers(1, 999, (N_AIDS, 6)).astype(np.int32)
        ),
        aid_emb=jnp.asarray(rng.normal(size=(N_AIDS, D)).astype(np.float32)),
    )

    # one bucket-L batch of real test sessions
    mb = None
    for p in pack_sessions(sp.test, (L,)):
        for m in iter_microbatches(p, S):
            mb = m
            break
        break
    padded = (jnp.asarray(mb.aid), jnp.asarray(mb.ts), jnp.asarray(mb.type))
    cluster = jnp.zeros(S, jnp.int32)
    semb = jnp.asarray(rng.normal(size=(S, D)).astype(np.float32))
    trim = jnp.asarray([20.0, 3.0, 17.0 / 29.0], jnp.float32)

    stages = ["fanout", "l1", "l2", "compact", ""]
    cum = {}
    for st in stages:
        out = retrieve_batch(padded, ctx, cluster, semb, trim, 20, 512, st)
        jax.block_until_ready(out)
        t0 = time.time()
        for _ in range(REPS):
            out = retrieve_batch(
                padded, ctx, cluster, semb, trim, 20, 512, st
            )
            jax.block_until_ready(out)
        cum[st] = (time.time() - t0) / REPS
    prev = 0.0
    print(f"--- {jax.devices()[0].device_kind} S={S} L={L} ---")
    for st in stages:
        name = st or "full"
        print(f"{name:8s} cum {cum[st]*1e3:8.1f} ms   "
              f"delta {(cum[st]-prev)*1e3:8.1f} ms")
        prev = cum[st]


if __name__ == "__main__":
    main()
