"""Phase-level covis + retrieval-pass profiling at smoke scale on the
card: where do the seconds per microbatch go? (pack / push / emit dispatch /
ladder merges / spill pulls / host merge)."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from otto_tpu.config import enable_persistent_compilation_cache

enable_persistent_compilation_cache()

from otto_tpu.config import CoVisConfig
from otto_tpu.data.batching import (
    dedup_events,
    iter_filled_microbatches,
    pack_sessions_filled,
)
from otto_tpu.data.split import split_events
from otto_tpu.data.synthetic import SyntheticSpec, generate_device
from otto_tpu.engine.covis import CoVisCounter, _emit_run_step
from otto_tpu.ops import pairs as pairs_ops

N = int(os.environ.get("N_SESSIONS", 300_000))
A = int(os.environ.get("N_AIDS", 300_000))

t0 = time.time()
ev = generate_device(SyntheticSpec(
    n_sessions=N, n_aids=A, mean_len=13.4, max_len=128, span_days=28, seed=7
))
print(f"gen {time.time()-t0:.1f}s ({len(ev)} events)", flush=True)

cfg = CoVisConfig()
counter = CoVisCounter(cfg)

t = time.time()
dd = dedup_events(ev)
print(f"dedup {time.time()-t:.1f}s", flush=True)
t = time.time()
packs = pack_sessions_filled(dd, counter.bucket_lens)
tot_lanes = sum(p.n_rows * p.max_len**2 for p in packs)
print(f"pack {time.time()-t:.1f}s ({tot_lanes/1e6:.0f}M lanes)", flush=True)

# phase A: emit-only (device->device, discard runs) with a sync at the end
t = time.time()
n_mb = 0
last = None
for filled in packs:
    L = filled.max_len
    s_batch = pairs_ops.pair_budget_sessions(L, counter.pair_budget)
    for mb in iter_filled_microbatches(filled, s_batch):
        last = _emit_run_step(
            counter.plan, counter.pair_budget, jnp.asarray(mb.aid),
            jnp.asarray(mb.ts), jnp.asarray(mb.type), jnp.asarray(mb.sess),
        )
        n_mb += 1
_ = int(np.asarray(last.n))
emit_s = time.time() - t
print(f"emit-only {emit_s:.1f}s for {n_mb} microbatches "
      f"({emit_s/n_mb*1e3:.0f} ms/mb)", flush=True)

# phase B: full update (emit + ladder + spills)
t = time.time()
for filled in packs:
    L = filled.max_len
    s_batch = pairs_ops.pair_budget_sessions(L, counter.pair_budget)
    for mb in iter_filled_microbatches(filled, s_batch):
        counter._ladder.push(_emit_run_step(
            counter.plan, counter.pair_budget, jnp.asarray(mb.aid),
            jnp.asarray(mb.ts), jnp.asarray(mb.type), jnp.asarray(mb.sess),
        ))
upd_s = time.time() - t
print(f"emit+ladder {upd_s:.1f}s ({upd_s/n_mb*1e3:.0f} ms/mb; ladder "
      f"overhead {(upd_s-emit_s)/n_mb*1e3:.0f} ms/mb)", flush=True)

t = time.time()
k1, k2, cnt = counter._ladder.host_merged()
print(f"drain+host_merge {time.time()-t:.1f}s "
      f"(spilled {counter._ladder._store.rows_spilled/1e6:.1f}M rows, "
      f"pruned {counter._ladder.rows_pruned/1e6:.1f}M)", flush=True)

t = time.time()
tabs = counter.retrieval_tables(A)
print(f"retrieval_tables {time.time()-t:.1f}s", flush=True)
print(f"TOTAL {time.time()-t0:.1f}s", flush=True)
