"""SGNS step-cost profiling at reference vocab scale (V=1.73M): chunk vs
pair vs scatter-variant steps; the 4 scatter-adds on [V, 100] tables are
the suspect."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from otto_tpu.config import enable_persistent_compilation_cache

enable_persistent_compilation_cache()

from otto_tpu.models import word2vec as w2v

V = int(os.environ.get("V", 1_733_412))
D = 100
B = int(os.environ.get("B", 65536))
N_POS = 20_000_000  # corpus positions (subset is fine for step cost)
WINDOW, NEGS = 10, 8

rng = np.random.default_rng(0)
params = w2v.init_params(V, D, seed=0)
words = jnp.asarray(rng.integers(0, V, N_POS).astype(np.int32))
lens = rng.integers(2, 30, N_POS // 10)
cum = np.zeros(len(lens) + 1, np.int64)
np.cumsum(lens, out=cum[1:])
cum = cum[cum <= N_POS][: (N_POS // 16)].astype(np.int32)
cum_d = jnp.asarray(cum)
neg_cdf = jnp.asarray(w2v.make_neg_cdf(np.ones(V)))
keep_prob = jnp.ones((V,), jnp.float32)
key = jax.random.PRNGKey(0)
lr = jnp.float32(0.025)


def sync(p):
    jax.block_until_ready(p)


def bench_mode(mode, n_steps=32, reps=4):
    # warm up THE SAME n_steps program (n_steps is static: a different
    # step count is a different compile), then average executions, so
    # compile-cache load is not counted as step cost
    t = time.time()
    p, _ = w2v.sgns_epoch_device(
        params, words, cum_d, neg_cdf, keep_prob, lr,
        B, WINDOW, NEGS, n_steps, key, mode,
    )
    sync(p)
    compile_s = time.time() - t
    t = time.time()
    for _ in range(reps):
        p, _ = w2v.sgns_epoch_device(
            params, words, cum_d, neg_cdf, keep_prob, lr,
            B, WINDOW, NEGS, n_steps, key, mode,
        )
    sync(p)
    dt = (time.time() - t) / reps
    print(f"{mode:8s} compile+1st {compile_s:6.1f}s   "
          f"{n_steps} steps {dt:6.2f}s = {dt/n_steps*1e3:7.1f} ms/step "
          f"({B/(dt/n_steps)/1e6:.2f}M pairs/s sampled)",
          flush=True)


def bench_fused(n_steps=32, reps=4):
    ti, to = w2v.fuse_params(params)
    t = time.time()
    ti2, to2, _ = w2v.sgns_epoch_device_fused(
        ti, to, words, cum_d, neg_cdf, keep_prob, lr,
        B, WINDOW, NEGS, n_steps, key,
    )
    _ = float(np.asarray(ti2[-1, -1]))
    compile_s = time.time() - t
    t = time.time()
    for _ in range(reps):
        ti2, to2, _ = w2v.sgns_epoch_device_fused(
            ti, to, words, cum_d, neg_cdf, keep_prob, lr,
            B, WINDOW, NEGS, n_steps, key,
        )
    _ = float(np.asarray(ti2[-1, -1]))
    dt = (time.time() - t) / reps
    print(f"{'fused':8s} compile+1st {compile_s:6.1f}s   "
          f"{n_steps} steps {dt:6.2f}s = {dt/n_steps*1e3:7.1f} ms/step",
          flush=True)


bench_fused()
bench_mode("chunk")


def bench_block(k=4, n_steps=32, label=None):
    """Round-4 block step: centers x k contexts, alias negatives, packed
    position map. Pairs/step = B (matching bench_mode for comparability)."""
    C = B // k
    prob, alias = w2v.make_alias(np.ones(V))
    prob_d, alias_d = jnp.asarray(prob), jnp.asarray(alias)
    # pos_info covers exactly cum[-1] positions; the sampler draws over
    # words.shape[0], so keep the two aligned
    pos_info = jnp.asarray(w2v.pack_position_info(np.asarray(cum)))
    t = time.time()
    p, _ = w2v.sgns_epoch_device_block(
        params, words, pos_info, prob_d, alias_d, keep_prob, lr,
        C, k, WINDOW, NEGS, n_steps, key,
    )
    sync(p)
    compile_s = time.time() - t
    reps = 4
    t = time.time()
    for _ in range(reps):
        p, _ = w2v.sgns_epoch_device_block(
            params, words, pos_info, prob_d, alias_d, keep_prob, lr,
            C, k, WINDOW, NEGS, n_steps, key,
        )
    sync(p)
    dt = (time.time() - t) / reps
    print(f"{label or f'block k={k}':12s} compile+1st {compile_s:6.1f}s   "
          f"{n_steps} steps {dt:6.2f}s = {dt/n_steps*1e3:7.1f} ms/step "
          f"({B/(dt/n_steps)/1e6:.2f}M pairs/s sampled)", flush=True)


if os.environ.get("BLOCK", "1") != "0":
    words = words[: int(cum[-1])]  # align sampler range with pos_info
    for k in (2, 4, 8):
        bench_block(k=k)
