"""GBDT lambdarank training/scoring throughput microbenchmark.

Reference point: LightGBM trains 3 lambdarank models (150 trees, depth 4)
over 40M/11M/7.5M downsampled rows in 5-10 min total on the baseline CPU
box (reference: model/train_lgbm_rankers.py:226, README.md:255-259) —
about 0.8-1.6M rows*trees/s. Prints rows*trees/s for the device trainer.

Usage: python scripts/bench_gbdt.py [n_groups] [group_size]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp

    from otto_tpu.config import GBDTConfig, enable_persistent_compilation_cache
    from otto_tpu.models.gbdt import _train_program, _predict_binned_program

    enable_persistent_compilation_cache()

    NG = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 15
    G = int(sys.argv[2]) if len(sys.argv) > 2 else 96
    F = 104
    cfg = GBDTConfig()
    rng = np.random.default_rng(0)

    bins = jnp.asarray(rng.integers(0, cfg.n_bins, (NG * G, F)).astype(np.uint8))
    labels = jnp.asarray((rng.random((NG, G)) < 0.05).astype(np.float32))
    mask = jnp.asarray(rng.random((NG, G)) < 0.8)

    t0 = time.time()
    out = _train_program(bins, labels, mask, cfg)
    jax.block_until_ready(out)
    cold = time.time() - t0

    times = []
    for _ in range(2):
        t0 = time.time()
        out = _train_program(bins, labels, mask, cfg)
        jax.block_until_ready(out)
        times.append(time.time() - t0)
    train_s = min(times)
    rows = NG * G
    rt_per_s = rows * cfg.n_trees / train_s

    # scoring throughput (binned predict over the same rows)
    gfeat, thr, leaf, _ = out
    t0 = time.time()
    s = _predict_binned_program(bins, gfeat, thr, leaf, cfg.n_bins)
    jax.block_until_ready(s)
    for _ in range(2):
        t0 = time.time()
        s = _predict_binned_program(bins, gfeat, thr, leaf, cfg.n_bins)
        jax.block_until_ready(s)
    pred_s = time.time() - t0

    print(f"# rows={rows} trees={cfg.n_trees} cold={cold:.1f}s "
          f"warm={train_s:.2f}s predict={pred_s:.3f}s", file=sys.stderr)
    print(
        '{"metric": "gbdt_train_rows_trees_per_s", "value": %.0f, '
        '"unit": "rows*trees/s", "vs_baseline": %.2f}'
        % (rt_per_s, rt_per_s / 1.2e6)
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
