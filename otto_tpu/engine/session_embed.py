"""Session embeddings + w2vec kNN tables (C9, C10).

Session embedding = type- and recency-weighted mean of member-aid w2vec
vectors (reference: model/kmeans_sessions.py:40-86):
  weight = weight_time * weight_type
  weight_time = clip(1 - (max_ts - ts) / 3d, min=0.10)
  weight_type = {click: .1, cart: .3, order: .6}
Missing-aid embeddings contribute zeros but их weight still enters the
denominator (reference joins then fill_null(0), :63).

The kNN tables replace the faiss IVF query loop (reference:
model/w2vec_aids.py:125-206): dense [n_aids, k] neighbour/distance tables
from exact search (ops/knn.py); rank == column index + 1 (exact search returns
neighbours distance-ascending, matching rank_w2vec semantics :170).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from otto_tpu.data.batching import PaddedSessions
from otto_tpu.models.word2vec import Word2Vec
from otto_tpu.ops.knn import knn_search

DAY = 24 * 60 * 60


@partial(jax.jit, static_argnums=())
def session_embedding_batch(
    aid: jnp.ndarray,      # [S, L] int32, -1 pad
    ts: jnp.ndarray,       # [S, L] int32
    type_: jnp.ndarray,    # [S, L] int32
    emb_table: jnp.ndarray,  # [A, D] float32 (0 for missing aids)
) -> jnp.ndarray:
    valid = aid >= 0
    max_ts = jnp.max(jnp.where(valid, ts, -(2**31 - 1)), axis=1, keepdims=True)
    w_time = jnp.clip(
        1.0 - (max_ts - ts).astype(jnp.float32) / (3 * DAY), 0.10, None
    )
    type_w = jnp.array([0.1, 0.3, 0.6], jnp.float32)
    w_type = type_w[jnp.clip(type_, 0, 2)]
    w = jnp.where(valid, w_time * w_type, 0.0)            # [S, L]
    vecs = emb_table[jnp.clip(aid, 0, emb_table.shape[0] - 1)]  # [S, L, D]
    # full f32: the embeddings feed kmeans and the retrieval cosine, which
    # are held to the CPU reference; TF32 would round each weight product
    num = jnp.einsum("sl,sld->sd", w, vecs,
                     precision=jax.lax.Precision.HIGHEST)
    den = jnp.maximum(jnp.sum(w, axis=1, keepdims=True), 1e-9)
    return num / den


@jax.jit
def _session_embedding_batch_stacked(stk: jnp.ndarray, emb_table: jnp.ndarray):
    """session_embedding_batch over ONE stacked [3, S, L] int32 upload
    (aid, ts, type), returning f16: one host->device transfer per
    microbatch instead of three, and the f16 pull halves the stage's
    dominant device->host byte count (12.9M x D f32 = 5.2 GB at
    reference scale). Embedding magnitudes are O(1), so f16 costs ~1e-3
    relative error — far under the kmeans quantization it feeds."""
    e = session_embedding_batch(stk[0], stk[1], stk[2], emb_table)
    return e.astype(jnp.float16)


def compute_session_embeddings(
    padded_batches, emb_table: np.ndarray, lane_budget: int = 1 << 19,
    mesh_ctx=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host driver over bucketed batches -> (session_ids [N], emb [N, D]).

    Buckets are micro-batched to ~lane_budget [S, L] lanes per dispatch:
    the gathered [S, L, D] vector grid is ~512 B/lane at D=128, so a whole
    10M-session bucket in one dispatch would materialize tens of GB
    (reference-scale OOM); fixed power-of-two microbatch shapes also keep
    the compiled-program set at one per bucket length.

    With `mesh_ctx`, microbatch rows are sharded over the data axis and the
    embedding table is replicated — pure data parallelism, the SPMD form of
    the reference's per-chunk weighted-mean join
    (reference: model/kmeans_sessions.py:40-86)."""
    from otto_tpu.data.batching import iter_microbatches

    table = jnp.asarray(emb_table)
    emb_fn = session_embedding_batch
    n_dev = 1
    if mesh_ctx is not None and mesh_ctx.n_devices > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P

        n_dev = mesh_ctx.mesh.shape[mesh_ctx.data_axis]
        sh = NamedSharding(mesh_ctx.mesh, P(mesh_ctx.data_axis))
        repl = NamedSharding(mesh_ctx.mesh, P())
        # f16 result like the single-device path: both paths must round
        # identically or the 1-vs-N pipeline invariance breaks downstream
        # (kmeans clusters -> popularity candidates -> retrieval ceiling)
        emb_fn = jax.jit(
            lambda a, t, ty, e: session_embedding_batch(a, t, ty, e).astype(
                jnp.float16
            ),
            in_shardings=(sh, sh, sh, repl), out_shardings=sh,
        )
    import logging
    import time

    log = logging.getLogger(__name__)

    sids, embs = [], []
    pending = None  # (kept session ids, device embedding handle)
    ph = {"host_batch": 0.0, "dispatch": 0.0, "pull": 0.0}
    n_mb = 0

    def collect(item):
        sess_keep, e, keep = item
        sids.append(sess_keep)
        # exact-size f32 copy: a view of the pulled f16 grid would keep the
        # padded base alive
        embs.append(np.asarray(e)[keep].astype(np.float32))

    # one-batch double buffer: batch N's device->host pull happens after
    # batch N+1's upload + compute are already enqueued
    # (copy_to_host_async at dispatch time), so the transfer overlaps
    # device work instead of serializing with it.
    t = time.time()
    for p in padded_batches:
        L = p.aid.shape[1]
        rows = max(8, 1 << (max(1, lane_budget // L).bit_length() - 1))
        rows = -(-rows // n_dev) * n_dev  # shard rows evenly
        for mb in iter_microbatches(p, min(rows, 1 << 20)):
            ph["host_batch"] += time.time() - t
            t = time.time()
            if n_dev > 1:
                e = emb_fn(
                    jnp.asarray(mb.aid), jnp.asarray(mb.ts),
                    jnp.asarray(mb.type), table,
                )
            else:
                # ONE stacked upload instead of three, f16 result
                e = _session_embedding_batch_stacked(
                    jnp.asarray(np.stack([mb.aid, mb.ts, mb.type])), table
                )
            try:
                e.copy_to_host_async()
            except (AttributeError, NotImplementedError):
                pass
            keep = mb.session >= 0
            ph["dispatch"] += time.time() - t
            t = time.time()
            if pending is not None:
                collect(pending)
            pending = (mb.session[keep], e, keep)
            n_mb += 1
            ph["pull"] += time.time() - t
            t = time.time()
    if pending is not None:
        collect(pending)
    session = np.concatenate(sids)
    emb = np.concatenate(embs)
    order = np.argsort(session)
    log.info(
        "session_emb: %d microbatches, phases %s",
        n_mb,
        {k: f"{v:.1f}s" for k, v in ph.items()},
    )
    return session[order], emb[order]


class KnnTables(NamedTuple):
    """Dense per-aid w2vec neighbour tables (reference df_knns columns
    aid, aid_next, dist_w2vec, rank_w2vec — model/w2vec_aids.py:167-171)."""

    neighbor: np.ndarray  # [A, k] int32, -1 pad (aids without neighbours)
    dist: np.ndarray      # [A, k] float32 squared-L2 (faiss METRIC_L2 analogue)


def build_knn_tables(
    model: Word2Vec, n_aids: int, k: int | None = None,
    first_n: int | None = None, mesh_ctx=None,
) -> KnnTables:
    """Search neighbours for the `first_n` most frequent words
    (reference: model/w2vec_aids.py:203 words[:first_n_aids]). With
    `mesh_ctx`, queries shard over the data axis (ops/knn.py)."""
    cfg = model.cfg
    k = k or cfg.knn_k
    first_n = min(first_n or cfg.knn_first_n_aids, model.vocab.size)
    emb = model.emb.astype(np.float32)
    queries = emb[:first_n]
    scores, idx = knn_search(queries, emb, k, metric="l2", mesh_ctx=mesh_ctx)
    nbr_aid = model.vocab.aid_of_word[idx]          # word idx -> aid
    nbr_aid = np.where(idx >= 0, nbr_aid, -1)
    dist = -scores  # score was negated squared L2

    neighbor = np.full((n_aids, k), -1, np.int32)
    dist_t = np.zeros((n_aids, k), np.float32)
    q_aids = model.vocab.aid_of_word[:first_n]
    neighbor[q_aids] = nbr_aid
    dist_t[q_aids] = dist
    return KnnTables(neighbor, dist_t)
