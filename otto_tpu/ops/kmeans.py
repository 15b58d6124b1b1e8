"""KMeans (Lloyd's) as device matmul + argmin + one-hot-matmul update (C11).

Replaces dask_ml / sklearn KMeans over chunked HDF5 arrays (reference:
model/kmeans_sessions.py:119-161, k=50, max_iter=100, tol=1e-3, seed=42).
The ENTIRE fit — k-means++ seeding, Lloyd iterations, tol check — runs as
one jitted program:

  * distance = matmul; assignment = argmin;
  * centroid update = one-hot x matmul contraction, not scatter-add — at
    k<=few hundred the [N, K] one-hot is cheap matmul work (ROADMAP D7);
  * both products run at Precision.HIGHEST: the distance |x|^2 + |c|^2 -
    2 x.c cancels for points near a centroid, and TF32 (a GPU's default
    for f32 matmuls) would flip near-tie assignments and round the means;
  * k-means++ seeding = lax.fori_loop of categorical draws from the D^2
    distribution (a host loop would pay a device round-trip and an [N]
    pull per centre);
  * Lloyd loop = lax.while_loop with the sklearn tol semantics inside
    (stop when squared Frobenius centroid shift <= tol * mean per-feature
    variance), so no per-iteration host sync.

Data-parallel over session shards with a psum when run under shard_map.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class KMeansState(NamedTuple):
    centroids: jnp.ndarray  # [K, D]
    inertia: jnp.ndarray    # []
    n_iter: jnp.ndarray     # []


@partial(jax.jit, static_argnums=())
def assign(x: jnp.ndarray, centroids: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(labels [N], sq-distances to the chosen centroid [N])."""
    x_sq = jnp.sum(x * x, axis=1, keepdims=True)
    c_sq = jnp.sum(centroids * centroids, axis=1)[None, :]
    d = x_sq + c_sq - 2.0 * jnp.dot(
        x, centroids.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    labels = jnp.argmin(d, axis=1).astype(jnp.int32)
    best = jnp.min(d, axis=1)
    return labels, jnp.maximum(best, 0.0)


def _lloyd_body(x, centroids, axis_name=None):
    """One Lloyd iteration. Empty clusters keep their previous centroid
    (sklearn re-seeds; at k=50 over millions of points empties are rare)."""
    K = centroids.shape[0]
    labels, dists = assign(x, centroids)
    # one-hot x matmul: the scatter-free groupby. f32 keeps the centroid
    # means exact; XLA fuses the one-hot materialization into the dot.
    onehot = (labels[:, None] == jnp.arange(K)[None, :]).astype(jnp.float32)
    sums = jnp.dot(onehot.T, x, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)               # [K, D]
    cnts = jnp.sum(onehot, axis=0)                                    # [K]
    inertia = jnp.sum(dists)
    if axis_name is not None:
        sums = jax.lax.psum(sums, axis_name)
        cnts = jax.lax.psum(cnts, axis_name)
        inertia = jax.lax.psum(inertia, axis_name)
    new = jnp.where(
        cnts[:, None] > 0, sums / jnp.maximum(cnts[:, None], 1.0), centroids
    )
    shift = jnp.sum((new - centroids) ** 2)
    return new, inertia, shift


@jax.jit
def lloyd_step(x: jnp.ndarray, centroids: jnp.ndarray):
    return _lloyd_body(x, centroids)


def _kmeanspp_init_device(x, k: int, key):
    """k-means++ seeding fully on device: one fori_loop of categorical
    draws proportional to squared distance from the chosen set."""
    n, d = x.shape
    k0, k1 = jax.random.split(key)
    first = jax.random.randint(k0, (), 0, n)
    c0 = x[first]
    d2 = jnp.sum((x - c0[None, :]) ** 2, axis=1)
    centers0 = jnp.zeros((k, d), x.dtype).at[0].set(c0)

    def body(i, carry):
        centers, d2 = carry
        ki = jax.random.fold_in(k1, i)
        # sample proportional to d2 (all-zero d2 -> uniform over index 0,
        # harmless duplicate centre)
        logits = jnp.where(d2 > 0, jnp.log(jnp.maximum(d2, 1e-30)), -jnp.inf)
        logits = jnp.where(jnp.any(d2 > 0), logits, jnp.zeros_like(d2))
        idx = jax.random.categorical(ki, logits)
        c = x[idx]
        centers = jax.lax.dynamic_update_index_in_dim(centers, c, i, 0)
        d2 = jnp.minimum(d2, jnp.sum((x - c[None, :]) ** 2, axis=1))
        return centers, d2

    centers, _ = jax.lax.fori_loop(1, k, body, (centers0, d2))
    return centers


def _fit_core(x, k: int, max_iter, init_sample: int, tol, key,
              axis_name=None):
    """Seeding + Lloyd-until-tol in ONE dispatch; returns
    (centroids, labels, inertia, n_iter).

    Seeding runs on a random subsample: k-means++ is k-1 SEQUENTIAL
    distance passes — on full data that costs as much as ~k extra Lloyd
    iterations while contributing only a starting point. At k=50 over
    millions of points a 64k-point D^2 sample seeds indistinguishably.

    The sklearn tol threshold (tol * mean per-feature variance) is
    computed HERE, so the point matrix never returns to the host.

    With axis_name (inside shard_map), x is the per-device point shard —
    the dask_ml distributed-KMeans analogue (reference:
    model/kmeans_sessions.py:144-150): the tol threshold comes from
    psum'd global moments, the init subsample is drawn per shard and
    all-gathered so every device seeds IDENTICAL centers, and each Lloyd
    step psums per-cluster (sum, count) — so all devices step through
    identical centroids and the while_loop exits in lockstep."""
    if axis_name is not None:
        n = jax.lax.psum(jnp.float32(x.shape[0]), axis_name)
        s1 = jax.lax.psum(jnp.sum(x, axis=0), axis_name)
        s2 = jax.lax.psum(jnp.sum(x * x, axis=0), axis_name)
        mean = s1 / n
        tol_thresh = tol * jnp.mean(s2 / n - mean * mean)
    else:
        tol_thresh = tol * jnp.mean(jnp.var(x, axis=0))
    kseed, kinit = jax.random.split(key)
    if axis_name is not None:
        kseed = jax.random.fold_in(kseed, jax.lax.axis_index(axis_name))
    if init_sample and init_sample < x.shape[0]:
        idx = jax.random.choice(
            kseed, x.shape[0], (init_sample,), replace=False
        )
        x_init = x[idx]
    else:
        x_init = x
    if axis_name is not None:
        x_init = jax.lax.all_gather(x_init, axis_name).reshape(
            -1, x.shape[1]
        )
    centroids = _kmeanspp_init_device(x_init, k, kinit)

    def cond(carry):
        _, _, shift, it = carry
        return (it < max_iter) & (shift > tol_thresh)

    def body(carry):
        c, _, _, it = carry
        new, inertia, shift = _lloyd_body(x, c, axis_name)
        return new, inertia, shift, it + 1

    init = (centroids, jnp.float32(jnp.inf), jnp.float32(jnp.inf),
            jnp.int32(0))
    centroids, inertia, _, n_iter = jax.lax.while_loop(cond, body, init)
    labels, _ = assign(x, centroids)
    return centroids, labels, inertia, n_iter


@partial(jax.jit, static_argnums=(1, 3))
def _fit_program(x, k: int, max_iter, init_sample: int, tol, key):
    return _fit_core(x, k, max_iter, init_sample, tol, key)


def kmeans_fit(
    x: np.ndarray,
    n_clusters: int,
    max_iter: int = 100,
    tol: float = 1e-3,
    seed: int = 42,
    init_sample: int = 1 << 16,
) -> Tuple[np.ndarray, np.ndarray, float, int]:
    """Fit KMeans; returns (centroids, labels, inertia, n_iter).

    Init: k-means++ (D^2 sampling — dask_ml's k-means|| analogue, reference:
    model/kmeans_sessions.py:144-150) on an init_sample-point subsample.
    tol semantics follow sklearn: stop when the squared Frobenius norm of
    the centroid shift drops below tol * mean per-feature variance.
    """
    xd = jnp.asarray(x, jnp.float32)
    key = jax.random.PRNGKey(seed)
    # max_iter and tol ride as traced scalars: ONE compiled program per
    # (data shape, k) regardless of iteration budget
    centroids, labels, inertia, n_iter = _fit_program(
        xd, n_clusters, jnp.int32(max_iter), int(init_sample),
        jnp.float32(tol), key
    )
    return (np.asarray(centroids), np.asarray(labels), float(inertia),
            int(n_iter))


def kmeans_fit_dp(
    x: np.ndarray,
    n_clusters: int,
    mesh,
    axis: str = "data",
    max_iter: int = 100,
    tol: float = 1e-3,
    seed: int = 42,
    init_sample: int = 1 << 16,
) -> Tuple[np.ndarray, np.ndarray, float, int]:
    """Data-parallel kmeans_fit: points row-sharded over `axis`, per-level
    (sum, count) psum — the dask_ml distributed KMeans analogue
    (reference: model/kmeans_sessions.py:144-150). Rows must divide the
    mesh axis; pad with copies of row 0 and drop the tail labels if not."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    n_dev = mesh.shape[axis]
    if x.shape[0] % n_dev:
        raise ValueError(f"rows {x.shape[0]} % mesh axis {n_dev} != 0")
    per_dev_sample = max(1, init_sample // n_dev)

    def core(xs, key):
        return _fit_core(
            xs, n_clusters, jnp.int32(max_iter), per_dev_sample,
            jnp.float32(tol), key, axis_name=axis,
        )

    fn = shard_map(
        core, mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=(P(), P(axis), P(), P()),
        check_vma=False,
    )
    key = jax.random.PRNGKey(seed)
    centroids, labels, inertia, n_iter = jax.jit(
        fn, static_argnums=()
    )(jnp.asarray(x, jnp.float32), key)
    return (np.asarray(centroids), np.asarray(labels), float(inertia),
            int(n_iter))
