"""Exact sharded top-k nearest neighbours (C9).

Replaces faiss IndexIVFFlat (nlist=100, nprobe=3 — a lossy ANN, reference:
model/w2vec_aids.py:98-110) with exact brute-force search: the corpus streams
through a matrix product in tiles, and a running top-k merges per tile via
lax.top_k. At OTTO scale (600k queries x 1.8M x 100) the score matrix is
216 TFLOP of dense matmul, and exact recall beats IVF's
(overlap stats in reference: model/w2vec_aids.py:237-241 show nprobe=3
agrees with exact search on only ~97% of neighbours at best).

Precision: the tile product runs at `lax.Precision.HIGHEST` (full f32). The
l2 score -(|q|^2 + |c|^2 - 2 q.c) subtracts two nearly equal terms for near
neighbours, so the ~3 decimal digits of TF32 (a GPU's default for f32
matmuls) can reorder close neighbours and lose the self-neighbour.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _topk_neighbors_impl(
    queries: jnp.ndarray,   # [Q, D]
    corpus: jnp.ndarray,    # [V, D]
    k: int,
    metric: str = "l2",
    tile: int = 8192,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact top-k by similarity. Returns (scores [Q, k], idx [Q, k]).

    metric 'l2'  -> returns negated squared L2 distance as score (larger =
                    closer), matching faiss METRIC_L2 ordering
                    (reference: model/w2vec_aids.py:104).
    metric 'dot' -> inner product (MIPS).
    metric 'cos' -> cosine similarity.

    With V < k the trailing columns carry score -inf and index -1.
    """
    Q, D = queries.shape
    V = corpus.shape[0]
    n_tiles = (V + tile - 1) // tile
    Vp = n_tiles * tile
    corpus_p = jnp.pad(corpus, ((0, Vp - V), (0, 0)))

    q = queries
    if metric == "cos":
        q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-9)
    q_sq = jnp.sum(q * q, axis=-1, keepdims=True)

    corpus_tiles = corpus_p.reshape(n_tiles, tile, D)

    def tile_scores(c_tile, base):
        if metric == "cos":
            c_tile = c_tile / jnp.maximum(
                jnp.linalg.norm(c_tile, axis=-1, keepdims=True), 1e-9
            )
        s = jnp.dot(q, c_tile.T, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)  # [Q, T]
        if metric == "l2":
            c_sq = jnp.sum(c_tile * c_tile, axis=-1)[None, :]
            s = -(q_sq + c_sq - 2.0 * s)  # -squared L2
        idx = base + jnp.arange(tile, dtype=jnp.int32)[None, :]
        # mask out padding rows of the corpus
        pad = idx >= V
        s = jnp.where(pad, -jnp.inf, s)
        return s, jnp.broadcast_to(jnp.where(pad, -1, idx), s.shape)

    def body(carry, inp):
        best_s, best_i = carry
        c_tile, base = inp
        s, idx = tile_scores(c_tile, base)
        cat_s = jnp.concatenate([best_s, s], axis=1)
        cat_i = jnp.concatenate([best_i, idx], axis=1)
        new_s, pos = jax.lax.top_k(cat_s, k)
        new_i = jnp.take_along_axis(cat_i, pos, axis=1)
        return (new_s, new_i), None

    init = (
        jnp.full((Q, k), -jnp.inf, jnp.float32),
        jnp.full((Q, k), -1, jnp.int32),
    )
    bases = (jnp.arange(n_tiles, dtype=jnp.int32) * tile)
    (scores, idx), _ = jax.lax.scan(body, init, (corpus_tiles, bases))
    return scores, idx


topk_neighbors = partial(jax.jit, static_argnums=(2, 3, 4))(
    _topk_neighbors_impl
)


def make_sharded_topk(mesh_ctx, k: int, metric: str = "l2", tile: int = 8192):
    """Query-sharded exact top-k: queries row-sharded over the data axis,
    corpus replicated (1.8M x 100 f32 = 720 MB/device).
    Each device searches its query rows independently; no collectives.
    This is the SPMD form of the reference's batched faiss query loop
    (reference: model/w2vec_aids.py:125-173)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh_ctx.mesh, P(mesh_ctx.data_axis))
    repl = NamedSharding(mesh_ctx.mesh, P())

    def run(q, c):
        return _topk_neighbors_impl(q, c, k, metric, tile)

    return jax.jit(run, in_shardings=(sh, repl), out_shardings=(sh, sh))


def corpus_tile(n_corpus: int, tile: int = 8192) -> int:
    """Corpus tile width: `tile`, shrunk to the next power of two >= the
    corpus (at least 128) so a small corpus is not padded to a full tile."""
    return min(tile, max(128, 1 << int(np.ceil(np.log2(max(n_corpus, 1))))))


def knn_search(
    queries: np.ndarray,
    corpus: np.ndarray,
    k: int,
    metric: str = "l2",
    query_block: int = 16384,
    tile: int = 8192,
    mesh_ctx=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host driver: stream query blocks through `topk_neighbors`.

    Blocks are padded to `query_block` rows whenever there is more than one
    block (or a mesh), so every dispatch reuses one compiled program.
    With `mesh_ctx`, query blocks are row-sharded over the data axis and
    each device searches the replicated corpus independently.
    """
    Q = queries.shape[0]
    tile = corpus_tile(corpus.shape[0], tile)
    sharded_fn = None
    if mesh_ctx is not None and mesh_ctx.n_devices > 1:
        n_dev = mesh_ctx.mesh.shape[mesh_ctx.data_axis]
        query_block = -(-query_block // n_dev) * n_dev
        sharded_fn = make_sharded_topk(mesh_ctx, k, metric, tile)
    out_s = np.empty((Q, k), np.float32)
    out_i = np.empty((Q, k), np.int32)
    corpus_d = jnp.asarray(corpus, jnp.float32)
    for i in range(0, Q, query_block):
        qb = np.asarray(queries[i : i + query_block], np.float32)
        nb = len(qb)
        if nb < query_block and (Q > query_block or sharded_fn is not None):
            qb = np.pad(qb, ((0, query_block - nb), (0, 0)))
        if sharded_fn is not None:
            s, ix = sharded_fn(jnp.asarray(qb), corpus_d)
        else:
            s, ix = topk_neighbors(jnp.asarray(qb), corpus_d, k, metric, tile)
        out_s[i : i + nb] = np.asarray(s)[:nb]
        out_i[i : i + nb] = np.asarray(ix)[:nb]
    return out_s, out_i
