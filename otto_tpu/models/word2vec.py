"""Skip-gram negative-sampling item embeddings in JAX (C8).

Replaces gensim's 16-thread hogwild C trainer (reference:
model/w2vec_aids.py:56-70, Word2Vec(vector_size=100, window=10, min_count=5))
with a batched SGNS program: the embedding tables live on device (row-sharded
over the 'model' mesh axis at scale), the host streams (center, context)
pairs, and negatives are drawn on device from the unigram^0.75 table.
Hogwild's racy updates become exact batched scatter-adds — deterministic and
vectorized.

Differences vs the reference, by design:
  * skip-gram instead of gensim's default CBOW (better for sparse item co-
    occurrence; the intentional model-class change is allowed per BASELINE).
  * dynamic window + frequent-word subsampling match gensim semantics.

Vocabulary order matches gensim's `wv.index_to_key` (frequency-descending,
reference: model/w2vec_aids.py:199) so the "first_n_aids most frequent"
kNN-query semantics (reference: config.py:109,125) carry over.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from functools import partial
from typing import Iterator, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from otto_tpu.config import Word2VecConfig
from otto_tpu.data.schema import Events

log = logging.getLogger(__name__)


class Vocab(NamedTuple):
    """aid <-> dense word-index maps, frequency-descending like gensim."""

    aid_of_word: np.ndarray   # [V] int32: word idx -> aid
    word_of_aid: np.ndarray   # [n_aids] int32: aid -> word idx, -1 if OOV
    counts: np.ndarray        # [V] int64 word frequencies

    @property
    def size(self) -> int:
        return len(self.aid_of_word)


def build_vocab(ev: Events, types: Tuple[int, ...], min_count: int, n_aids: Optional[int] = None) -> Vocab:
    m = np.isin(ev.type, np.asarray(types, np.int8))
    aids = ev.aid[m]
    n_aids = n_aids or (int(ev.aid.max()) + 1)
    counts = np.bincount(aids, minlength=n_aids)
    keep = counts >= min_count
    kept_aids = np.nonzero(keep)[0]
    order = np.argsort(-counts[kept_aids], kind="stable")
    aid_of_word = kept_aids[order].astype(np.int32)
    word_of_aid = np.full(n_aids, -1, np.int32)
    word_of_aid[aid_of_word] = np.arange(len(aid_of_word), dtype=np.int32)
    return Vocab(aid_of_word, word_of_aid, counts[aid_of_word].astype(np.int64))


class SGNSParams(NamedTuple):
    emb_in: jnp.ndarray   # [V, D] float32
    emb_out: jnp.ndarray  # [V, D] float32
    acc_in: jnp.ndarray   # [V] float32 Adagrad accumulators (per row)
    acc_out: jnp.ndarray  # [V] float32


def init_params(vocab_size: int, dim: int, seed: int) -> SGNSParams:
    k = jax.random.PRNGKey(seed)
    emb_in = (jax.random.uniform(k, (vocab_size, dim)) - 0.5) / dim
    emb_out = jnp.zeros((vocab_size, dim), jnp.float32)
    acc_in = jnp.full((vocab_size,), 1e-6, jnp.float32)
    acc_out = jnp.full((vocab_size,), 1e-6, jnp.float32)
    return SGNSParams(emb_in, emb_out, acc_in, acc_out)


def _sgns_loss(params: SGNSParams, center, pos, negs):
    """-log s(in_c . out_p) - sum log s(-in_c . out_n).

    SUM-reduced: a row's gradient accumulates one term per occurrence in the
    batch, so lr keeps gensim's per-pair semantics (sequential hogwild SGD,
    reference: model/w2vec_aids.py:63) rather than shrinking with batch size.
    """
    c = params.emb_in[center]                      # [B, D]
    p = params.emb_out[pos]                        # [B, D]
    n = params.emb_out[negs]                       # [B, K, D]
    pos_logit = jnp.sum(c * p, axis=-1)
    neg_logit = jnp.einsum("bd,bkd->bk", c, n)
    loss = -jax.nn.log_sigmoid(pos_logit) - jnp.sum(
        jax.nn.log_sigmoid(-neg_logit), axis=-1
    )
    return jnp.sum(loss)


@partial(jax.jit, static_argnums=(6,))
def sgns_step(
    params: SGNSParams,
    center: jnp.ndarray,     # [B] int32
    pos: jnp.ndarray,        # [B] int32
    neg_cdf: jnp.ndarray,    # [V] float32 unigram^0.75 CDF
    lr: jnp.ndarray,         # [] float32
    key: jnp.ndarray,
    n_negs: int = 8,
) -> Tuple[SGNSParams, jnp.ndarray]:
    B = center.shape[0]
    u = jax.random.uniform(key, (B, n_negs))
    negs = jnp.searchsorted(neg_cdf, u).astype(jnp.int32)
    loss, grads = jax.value_and_grad(_sgns_loss)(params, center, pos, negs)
    # per-row Adagrad: frequent rows (many accumulated pair grads per batch)
    # get proportionally damped steps — the batched analogue of hogwild's
    # many small sequential updates.
    g_in_sq = jnp.mean(grads.emb_in**2, axis=1)
    g_out_sq = jnp.mean(grads.emb_out**2, axis=1)
    acc_in = params.acc_in + g_in_sq
    acc_out = params.acc_out + g_out_sq
    scale_in = lr * jax.lax.rsqrt(acc_in + 1e-8)
    scale_out = lr * jax.lax.rsqrt(acc_out + 1e-8)
    new = SGNSParams(
        emb_in=params.emb_in - scale_in[:, None] * grads.emb_in,
        emb_out=params.emb_out - scale_out[:, None] * grads.emb_out,
        acc_in=acc_in,
        acc_out=acc_out,
    )
    return new, loss / B


# keep a non-donating alias for shape-probing / multi-chip dryrun
sgns_step_ref = sgns_step


# ---------------------------------------------------------------------------
# Device-side skip-gram sampling: the production training path. The host
# uploads padded session tensors ONCE; every step samples (center, context,
# negatives) on device — no host pair materialization, no PCIe streaming
# (the gensim path re-reads all sentences per epoch,
# reference: model/w2vec_aids.py:62-63).
# ---------------------------------------------------------------------------
# negatives are shared within chunks of this many pairs (not per pair, not
# across the whole batch): per-pair scatters dominated the step cost, while
# batch-global sharing correlated the updates enough to hurt embedding
# quality at small scale. Each chunk draws n_negs * _SHARED_NEG_FACTOR ids.
# 256 (vs the original 64): where it was first profiled the step was bound
# by scattered ROW count, and quartering the negative-pool rows cut step
# time with no measurable recall change on the 20k synthetic eval.
_NEG_CHUNK = 256
_SHARED_NEG_FACTOR = 8


def _sample_pair_batch(words, cum_len, keep_prob, batch, window, key):
    """Device-side (center, context, valid, neg_key) sampling over the flat
    ragged corpus — shared by the single-device and model-parallel steps.
    Pure function of (corpus, key): replicating it across shards with the
    same key reproduces identical index streams on every device."""
    N = words.shape[0]
    S = cum_len.shape[0] - 1
    total = cum_len[-1]
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)

    # sample positions proportional to session length (matches the gensim
    # sweep where long sessions contribute more pairs)
    u = jax.random.uniform(k1, (batch,)) * total.astype(jnp.float32)
    flat = jnp.minimum(u.astype(jnp.int32), total - 1)
    sess = jnp.searchsorted(cum_len, flat, side="right") - 1
    sess = jnp.clip(sess, 0, S - 1)
    base = cum_len[sess]
    pos = flat - base
    sess_len = cum_len[sess + 1] - base

    # dynamic window: b ~ U{1..window}, offset ~ +-U{1..b}
    b = jax.random.randint(k2, (batch,), 1, window + 1)
    off = jax.random.randint(k3, (batch,), 1, window + 1) % b + 1
    sign = jnp.where(jax.random.bernoulli(k4, 0.5, (batch,)), 1, -1)
    ctx_pos = pos + sign * off
    in_bounds = (ctx_pos >= 0) & (ctx_pos < sess_len)
    ctx_idx = base + jnp.clip(ctx_pos, 0, jnp.maximum(sess_len - 1, 0))

    center = words[jnp.clip(flat, 0, N - 1)]
    context = words[jnp.clip(ctx_idx, 0, N - 1)]
    valid = in_bounds & (center >= 0) & (context >= 0)

    # frequent-word subsampling on both ends (gensim drops words from the
    # sentence stream; dropping pairs whose either end is dropped is the
    # sampled equivalent)
    su = jax.random.uniform(k5, (batch, 2))
    c_safe = jnp.clip(center, 0, None)
    x_safe = jnp.clip(context, 0, None)
    keep = (su[:, 0] < keep_prob[c_safe]) & (su[:, 1] < keep_prob[x_safe])
    valid = valid & keep
    return c_safe, x_safe, valid, k6


def _chunk_neg_grads(c, rows_out, valid, batch: int, n_negs: int):
    """Chunk-shared-negative SGNS gradients from gathered rows.

    c [B, D] center rows; rows_out [B + Nc*Ks, D] = context rows ++ shared
    negative-pool rows. Returns (g_c [B, D], g_out [B + Nc*Ks, D], loss,
    n_valid). Pure math on gathered rows — shared verbatim by the
    single-device step and the row-sharded model-parallel step (which only
    differ in HOW rows are gathered/scattered)."""
    Bc = min(_NEG_CHUNK, batch)
    Nc = max(1, batch // Bc)
    Ks = n_negs * _SHARED_NEG_FACTOR
    D = c.shape[-1]
    vf = valid.astype(jnp.float32)
    pv = rows_out[:batch]                     # [B, D]
    pos_logit = jnp.sum(c * pv, axis=-1)      # [B]
    # d/dz of -log_sigmoid(z) = sigmoid(z)-1; of -log_sigmoid(-z) = sigmoid(z)
    d_pos = (jax.nn.sigmoid(pos_logit) - 1.0) * vf
    n = rows_out[batch:].reshape(Nc, Ks, D)
    cc = c.reshape(Nc, Bc, D)
    vc = vf.reshape(Nc, Bc)
    neg_logit = jnp.einsum("nbd,nkd->nbk", cc, n)              # [Nc, Bc, Ks]
    # averaged over the pool so the positive:negative gradient balance
    # matches per-pair SGNS with n_negs draws
    neg_w = jnp.float32(n_negs) / jnp.float32(Ks)
    d_neg = jax.nn.sigmoid(neg_logit) * (vc[:, :, None] * neg_w)
    g_c = d_pos[:, None] * pv + jnp.einsum(
        "nbk,nkd->nbd", d_neg, n
    ).reshape(-1, D)
    g_n = jnp.einsum("nbk,nbd->nkd", d_neg, cc)                # [Nc, Ks, D]
    g_pv = d_pos[:, None] * c
    g_out = jnp.concatenate([g_pv, g_n.reshape(-1, D)])
    per_pair = -jax.nn.log_sigmoid(pos_logit) - neg_w * jnp.sum(
        jax.nn.log_sigmoid(-neg_logit), axis=-1
    ).reshape(-1)
    loss = jnp.sum(jnp.where(valid, per_pair, 0.0))
    n_valid = jnp.maximum(jnp.sum(valid), 1)
    return g_c, g_out, loss, n_valid


# ---------------------------------------------------------------------------
# Block-sampled SGNS step (production fast path, round 4).
#
# Same stochastic objective as the chunk step, reorganized so that a step
# does fewer searchsorted lookups and scatter-adds, the costliest of its
# primitives where it was first profiled (on a GPU the ranking is
# unmeasured, ROADMAP §1 item 3):
#   1. POSITION MAP, not binary search: the per-position (offset-in-session,
#      session-length) pair is precomputed host-side and packed into ONE
#      int32 (`pack_position_info`), so locating a sampled corpus position
#      costs one random gather instead of a 24-probe searchsorted over
#      cum_len plus two more gathers.
#   2. ALIAS sampling, not CDF search: negatives draw via the Walker alias
#      method (two gathers + select) instead of searchsorted over the
#      unigram^0.75 CDF.
#   3. CENTER BLOCKS: each sampled center emits `k` context pairs (gensim's
#      sweep emits up to 2*window pairs per position, reference:
#      model/w2vec_aids.py:63); the center row is gathered once, its k pair
#      gradients accumulate in registers, and the emb_in scatter shrinks to
#      B/k rows — scatter-add rows are the step's scarcest resource.
# ---------------------------------------------------------------------------


def pack_position_info(cum: np.ndarray) -> np.ndarray:
    """cum_len [S+1] -> packed [N] int32: (pos_in_session << 16) | length.
    Sessions cap at 465 events (reference: README.md:18), far under the
    16-bit fields. One device gather of this array replaces the
    searchsorted(cum_len) session lookup in the sampling hot path."""
    lens = np.diff(cum).astype(np.int64)
    n = int(cum[-1])
    pos_in = np.arange(n, dtype=np.int64) - np.repeat(cum[:-1].astype(np.int64), lens)
    slen = np.repeat(np.minimum(lens, 0xFFFF), lens)
    return ((pos_in << 16) | slen).astype(np.int32)


def make_alias(counts: np.ndarray, ns_exponent: float = 0.75):
    """Walker alias tables for the unigram^ns_exponent negative
    distribution: (prob [V] f32, alias [V] i32). Vose's O(V) construction
    on host; sampling is j ~ U{0..V-1}, u ~ U[0,1): u < prob[j] ? j :
    alias[j] — two gathers, no log(V) search."""
    p = np.asarray(counts, np.float64) ** ns_exponent
    p = p / p.sum()
    V = len(p)
    scaled = p * V
    alias = np.zeros(V, np.int32)
    prob = np.ones(V, np.float32)
    small = [i for i in range(V) if scaled[i] < 1.0]
    large = [i for i in range(V) if scaled[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    return prob, alias


def _alias_draw(prob, alias, n: int, key):
    ka, kb = jax.random.split(key)
    j = jax.random.randint(ka, (n,), 0, prob.shape[0])
    u = jax.random.uniform(kb, (n,))
    return jnp.where(u < prob[j], j, alias[j]).astype(jnp.int32)


def _sample_center_block(words, pos_info, keep_prob, C: int, k: int,
                         window: int, key):
    """Sample C centers x k dynamic-window contexts over the flat corpus.
    Returns (c_safe [C], x_safe [C*k], valid [C*k], neg_key)."""
    N = words.shape[0]
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)

    flat = jax.random.randint(k1, (C,), 0, N)
    info = pos_info[flat]
    pos = info >> 16
    slen = info & 0xFFFF
    center = words[flat]

    # gensim's reduced window: b ~ U{1..window} per CENTER, offsets U{±1..b}
    b = jax.random.randint(k2, (C,), 1, window + 1)
    off = jax.random.randint(k3, (C, k), 0, window) % b[:, None] + 1
    sign = jnp.where(jax.random.bernoulli(k4, 0.5, (C, k)), 1, -1)
    ctx_pos = pos[:, None] + sign * off
    in_bounds = (ctx_pos >= 0) & (ctx_pos < slen[:, None])
    base = flat - pos
    ctx_idx = base[:, None] + jnp.clip(
        ctx_pos, 0, jnp.maximum(slen - 1, 0)[:, None]
    )
    context = words[jnp.clip(ctx_idx.reshape(-1), 0, N - 1)]

    su = jax.random.uniform(k5, (C, k + 1))
    c_safe = jnp.clip(center, 0, None)
    x_safe = jnp.clip(context, 0, None)
    keep_c = su[:, 0] < keep_prob[c_safe]
    keep_x = (su[:, 1:].reshape(-1) < keep_prob[x_safe])
    valid = (
        in_bounds.reshape(-1)
        & jnp.repeat(keep_c, k, total_repeat_length=C * k)
        & keep_x
        & (jnp.repeat(center, k, total_repeat_length=C * k) >= 0)
        & (context >= 0)
    )
    return c_safe, x_safe, valid, k6


def _block_neg_grads(c, pv, negs_rows, valid, n_negs: int):
    """Center-block SGNS gradients. c [C, D] center rows; pv [C, k, D]
    context rows; negs_rows [Nc, Ks, D] shared negative pool (chunks of
    C/Nc centers); valid [C, k]. Negative gradients weight by the center's
    VALID pair count so the positive:negative balance matches per-pair
    SGNS with n_negs draws. Returns (g_c [C, D], g_pv [C, k, D],
    g_n [Nc, Ks, D], loss, n_valid)."""
    C, k, D = pv.shape
    Nc, Ks, _ = negs_rows.shape
    Bc = C // Nc
    vf = valid.astype(jnp.float32)                      # [C, k]

    pos_logit = jnp.einsum("cd,ckd->ck", c, pv)
    d_pos = (jax.nn.sigmoid(pos_logit) - 1.0) * vf      # [C, k]
    g_pv = d_pos[:, :, None] * c[:, None, :]            # [C, k, D]

    cc = c.reshape(Nc, Bc, D)
    neg_logit = jnp.einsum("nbd,nkd->nbk", cc, negs_rows)   # [Nc, Bc, Ks]
    w_center = vf.sum(axis=1).reshape(Nc, Bc) * (
        jnp.float32(n_negs) / jnp.float32(Ks)
    )
    d_neg = jax.nn.sigmoid(neg_logit) * w_center[:, :, None]
    g_c = (d_pos[:, :, None] * pv).sum(axis=1) + jnp.einsum(
        "nbk,nkd->nbd", d_neg, negs_rows
    ).reshape(C, D)
    g_n = jnp.einsum("nbk,nbd->nkd", d_neg, cc)             # [Nc, Ks, D]

    # loss bookkeeping mirrors the chunk step: positive term per valid
    # pair + pool-averaged negative term counted once per valid pair
    # (w_center already folds n_valid(center) * n_negs / Ks)
    per_center_neg = -jnp.einsum(
        "nbk->nb", jax.nn.log_sigmoid(-neg_logit)
    ).reshape(C) * w_center.reshape(C)
    loss = jnp.sum(-jax.nn.log_sigmoid(pos_logit) * vf) + jnp.sum(
        per_center_neg
    )
    n_valid = jnp.maximum(jnp.sum(valid), 1)
    return g_c, g_pv, g_n, loss, n_valid


def _sgns_step_body_block(
    params: SGNSParams,
    words, pos_info, neg_prob, neg_alias, keep_prob, lr,
    n_centers: int, block_k: int, window: int, n_negs: int, key,
    optimizer: str = "adagrad",
) -> Tuple[SGNSParams, jnp.ndarray]:
    C, k = n_centers, block_k
    B = C * k
    D = params.emb_in.shape[1]
    c_safe, x_safe, valid, k6 = _sample_center_block(
        words, pos_info, keep_prob, C, k, window, key
    )
    # negative pool shared per chunk of ~_NEG_CHUNK pairs, in whole centers
    cpc = max(1, _NEG_CHUNK // k)            # centers per chunk
    Nc = max(1, C // cpc)                    # trainer rounds C to cpc
    Ks = n_negs * _SHARED_NEG_FACTOR
    negs_f = _alias_draw(neg_prob, neg_alias, Nc * Ks, k6)

    ids_out = jnp.concatenate([x_safe, negs_f])
    rows_out = params.emb_out[ids_out]                  # [B + Nc*Ks, D]
    c = params.emb_in[c_safe]                           # [C, D]
    g_c, g_pv, g_n, loss, n_valid = _block_neg_grads(
        c, rows_out[:B].reshape(C, k, D), rows_out[B:].reshape(Nc, Ks, D),
        valid.reshape(C, k), n_negs,
    )
    g_out = jnp.concatenate([g_pv.reshape(B, D), g_n.reshape(-1, D)])

    if optimizer == "sgd":
        # gensim-parity plain SGD (linear lr decay is the CALLER's job via
        # the traced lr argument, reference: gensim alpha->min_alpha sweep
        # in model/w2vec_aids.py:63 defaults). Skips all 4 accumulator
        # gathers/scatters — measurably cheaper per step.
        new = SGNSParams(
            emb_in=params.emb_in.at[c_safe].add(-lr * g_c),
            emb_out=params.emb_out.at[ids_out].add(-lr * g_out),
            acc_in=params.acc_in,
            acc_out=params.acc_out,
        )
        return new, loss / n_valid.astype(jnp.float32)

    # per-row Adagrad with pre-update accumulators (same batched-hogwild
    # staleness semantics as the chunk step)
    gsq_c = jnp.mean(g_c ** 2, axis=1)
    gsq_out = jnp.mean(g_out ** 2, axis=1)
    scale_c = lr * jax.lax.rsqrt(params.acc_in[c_safe] + gsq_c + 1e-8)
    scale_out = lr * jax.lax.rsqrt(params.acc_out[ids_out] + gsq_out + 1e-8)
    new = SGNSParams(
        emb_in=params.emb_in.at[c_safe].add(-scale_c[:, None] * g_c),
        emb_out=params.emb_out.at[ids_out].add(-scale_out[:, None] * g_out),
        acc_in=params.acc_in.at[c_safe].add(gsq_c),
        acc_out=params.acc_out.at[ids_out].add(gsq_out),
    )
    return new, loss / n_valid.astype(jnp.float32)


@partial(jax.jit, static_argnums=(7, 8, 9, 10, 11, 13))
def sgns_epoch_device_block(
    params, words, pos_info, neg_prob, neg_alias, keep_prob, lr,
    n_centers: int, block_k: int, window: int, n_negs: int, n_steps: int,
    key, optimizer: str = "adagrad",
):
    """n_steps block-sampled steps in one dispatch (cf. sgns_epoch_device)."""

    def body(i, carry):
        p, _ = carry
        sub = jax.random.fold_in(key, i)
        return _sgns_step_body_block(
            p, words, pos_info, neg_prob, neg_alias, keep_prob, lr,
            n_centers, block_k, window, n_negs, sub, optimizer,
        )

    return lax.fori_loop(
        0, n_steps, body, (params, jnp.float32(0.0))
    )


def _sgns_step_body(
    params: SGNSParams,
    words: jnp.ndarray,      # [N] int32 word ids, FLAT ragged corpus
    cum_len: jnp.ndarray,    # [S+1] int32 session start offsets into words
    neg_cdf: jnp.ndarray,    # [V] float32
    keep_prob: jnp.ndarray,  # [V] float32 subsampling keep probability
    lr: jnp.ndarray,
    batch: int,
    window: int,
    n_negs: int,
    key: jnp.ndarray,
    neg_mode: str = "pair",
) -> Tuple[SGNSParams, jnp.ndarray]:
    # FLAT corpus layout: sessions are contiguous runs words[cum_len[s] :
    # cum_len[s+1]] — zero padding, so the whole 220M-event OTTO corpus is
    # ~880 MB on device (the padded [S, L] grid it replaced needed 13 GB at
    # reference scale and would not fit HBM next to the embedding tables).
    c_safe, x_safe, valid, k6 = _sample_pair_batch(
        words, cum_len, keep_prob, batch, window, key
    )

    if neg_mode == "chunk":
        # SPARSE step, negatives SHARED within Bc-pair chunks: gather the
        # touched rows, compute the gradients by hand, scatter-add them
        # back — the negative tower is matmul work + a small scatter,
        # instead of the dense step below, which streams the full [V, D]
        # table 3x. The trade-off: fewer fresh
        # negative draws per step measurably weakens embeddings on SMALL
        # corpora (few total steps), so this is the opt-in production mode
        # (see Word2VecConfig.neg_sharing).
        un = jax.random.uniform(k6, (max(1, batch // min(_NEG_CHUNK, batch)),
                                     n_negs * _SHARED_NEG_FACTOR))
        negs_f = jnp.searchsorted(neg_cdf, un).astype(jnp.int32).reshape(-1)

        # one fused gather / one fused scatter per table (chained .at[]
        # calls each cost a separate scatter pass)
        ids_out = jnp.concatenate([x_safe, negs_f])
        rows_out = params.emb_out[ids_out]        # [B + Nc*Ks, D]
        c = params.emb_in[c_safe]                 # [B, D]
        g_c, g_out, loss, n_valid = _chunk_neg_grads(
            c, rows_out, valid, batch, n_negs
        )

        # per-row Adagrad with pre-update accumulators (duplicate ids in a
        # batch see slightly stale scales — the batched analogue of gensim's
        # intentionally racy hogwild updates, reference: model/w2vec_aids.py:63)
        gsq_c = jnp.mean(g_c**2, axis=1)
        gsq_out = jnp.mean(g_out**2, axis=1)
        scale_c = lr * jax.lax.rsqrt(params.acc_in[c_safe] + gsq_c + 1e-8)
        scale_out = lr * jax.lax.rsqrt(params.acc_out[ids_out] + gsq_out + 1e-8)
        new = SGNSParams(
            emb_in=params.emb_in.at[c_safe].add(-scale_c[:, None] * g_c),
            emb_out=params.emb_out.at[ids_out].add(-scale_out[:, None] * g_out),
            acc_in=params.acc_in.at[c_safe].add(gsq_c),
            acc_out=params.acc_out.at[ids_out].add(gsq_out),
        )
        return new, loss / n_valid.astype(jnp.float32)

    # 'pair' (default): per-pair negatives with DENSE autodiff grads and
    # whole-table Adagrad — the quality-reference path (gensim-parity
    # stochastic dynamics, reference: model/w2vec_aids.py:63). Its step
    # cost is 3 full-table passes regardless of batch size, so large
    # batches amortize it; a hand-written sparse per-pair variant was
    # NOT faster (the [B*K, D] scatter/gather rows cost the same) and its
    # per-occurrence Adagrad measurably hurt retrieval recall.
    un = jax.random.uniform(k6, (batch, n_negs))
    negs = jnp.searchsorted(neg_cdf, un).astype(jnp.int32)

    def loss_fn(p):
        c = p.emb_in[c_safe]
        pv = p.emb_out[x_safe]
        n = p.emb_out[negs]
        pos_logit = jnp.sum(c * pv, axis=-1)
        neg_logit = jnp.einsum("bd,bkd->bk", c, n)
        per_pair = -jax.nn.log_sigmoid(pos_logit) - jnp.sum(
            jax.nn.log_sigmoid(-neg_logit), axis=-1
        )
        return jnp.sum(jnp.where(valid, per_pair, 0.0))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    g_in_sq = jnp.mean(grads.emb_in**2, axis=1)
    g_out_sq = jnp.mean(grads.emb_out**2, axis=1)
    acc_in = params.acc_in + g_in_sq
    acc_out = params.acc_out + g_out_sq
    new = SGNSParams(
        emb_in=params.emb_in - (lr * jax.lax.rsqrt(acc_in + 1e-8))[:, None] * grads.emb_in,
        emb_out=params.emb_out - (lr * jax.lax.rsqrt(acc_out + 1e-8))[:, None] * grads.emb_out,
        acc_in=acc_in,
        acc_out=acc_out,
    )
    n_valid = jnp.maximum(jnp.sum(valid), 1)
    return new, loss / n_valid.astype(jnp.float32)


sgns_step_device_sampled = partial(
    jax.jit, static_argnums=(6, 7, 8, 10)
)(_sgns_step_body)


def make_neg_cdf(counts: np.ndarray, ns_exponent: float = 0.75) -> np.ndarray:
    p = counts.astype(np.float64) ** ns_exponent
    cdf = np.cumsum(p / p.sum())
    cdf[-1] = 1.0
    return cdf.astype(np.float32)


def skipgram_pairs(
    ev: Events,
    vocab: Vocab,
    types: Tuple[int, ...],
    window: int,
    subsample_t: float,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side pair generation with gensim semantics: per-position dynamic
    window b ~ U{1..window}; frequent-word subsampling with threshold t."""
    m = np.isin(ev.type, np.asarray(types, np.int8))
    sess = ev.session[m]
    words = vocab.word_of_aid[ev.aid[m]]
    keep = words >= 0
    sess, words = sess[keep], words[keep]

    if subsample_t > 0:
        freq = vocab.counts / vocab.counts.sum()
        keep_prob = np.minimum(
            1.0, np.sqrt(subsample_t / np.maximum(freq, 1e-12))
            + subsample_t / np.maximum(freq, 1e-12)
        )
        keep = rng.random(len(words)) < keep_prob[words]
        sess, words = sess[keep], words[keep]

    if len(words) == 0:
        return np.array([], np.int32), np.array([], np.int32)

    # session boundaries (input is session-sorted)
    boundary = np.empty(len(sess), bool)
    boundary[0] = True
    boundary[1:] = sess[1:] != sess[:-1]
    sess_start_idx = np.maximum.accumulate(np.where(boundary, np.arange(len(sess)), 0))
    # next boundary (exclusive end of session) per position
    end_idx = np.empty(len(sess), np.int64)
    ends = np.append(np.nonzero(boundary)[0][1:], len(sess))
    end_idx = ends[np.cumsum(boundary) - 1]

    centers, contexts = [], []
    b = rng.integers(1, window + 1, size=len(words))
    pos = np.arange(len(words))
    for off in range(1, window + 1):
        ok = b >= off
        # context at +off
        j = pos + off
        sel = ok & (j < end_idx)
        centers.append(words[pos[sel]])
        contexts.append(words[j[sel]])
        # context at -off
        j2 = pos - off
        sel2 = ok & (j2 >= sess_start_idx)
        centers.append(words[pos[sel2]])
        contexts.append(words[j2[sel2]])
    c = np.concatenate(centers).astype(np.int32)
    x = np.concatenate(contexts).astype(np.int32)
    perm = rng.permutation(len(c))
    return c[perm], x[perm]


@dataclasses.dataclass
class Word2Vec:
    """Trained model: vocabulary + embeddings (gensim .model analogue,
    reference: model/w2vec_aids.py:64)."""

    cfg: Word2VecConfig
    vocab: Vocab
    emb: np.ndarray  # [V, dim] float32 input embeddings (wv.vectors analogue)

    def embedding_by_aid(self, n_aids: int) -> np.ndarray:
        """[n_aids, dim] table, zeros for OOV aids (reference fills missing
        embeddings with 0, model/kmeans_sessions.py:63)."""
        out = np.zeros((n_aids, self.emb.shape[1]), np.float32)
        out[self.vocab.aid_of_word] = self.emb
        return out

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            aid_of_word=self.vocab.aid_of_word,
            word_of_aid=self.vocab.word_of_aid,
            counts=self.vocab.counts,
            emb=self.emb,
        )

    @staticmethod
    def load(path: str, cfg: Word2VecConfig) -> "Word2Vec":
        z = np.load(path)
        return Word2Vec(
            cfg,
            Vocab(z["aid_of_word"], z["word_of_aid"], z["counts"]),
            z["emb"],
        )


# no donate_argnums: donated-buffer programs miss the persistent compile
# cache on this runtime (see engine/covis.py note); the epoch-boundary param
# copy is trivial next to minutes of recompile.
@partial(jax.jit, static_argnums=(6, 7, 8, 9, 11))
def sgns_epoch_device(
    params: SGNSParams,
    words: jnp.ndarray,
    cum_len: jnp.ndarray,
    neg_cdf: jnp.ndarray,
    keep_prob: jnp.ndarray,
    lr: jnp.ndarray,
    batch: int,
    window: int,
    n_negs: int,
    n_steps: int,
    key: jnp.ndarray,
    neg_mode: str = "pair",
) -> Tuple[SGNSParams, jnp.ndarray]:
    """n_steps SGNS updates in ONE dispatch (lax.fori_loop), so the host
    does not round-trip per step. Jitted with static step count — the
    training loop re-invokes this with one fixed chunk size, so every
    dispatch reuses one compiled program."""

    def body(i, carry):
        params, _ = carry
        sub = jax.random.fold_in(key, i)
        return _sgns_step_body(
            params, words, cum_len, neg_cdf, keep_prob, lr,
            batch, window, n_negs, sub, neg_mode,
        )

    return lax.fori_loop(
        0, n_steps, body, (params, jnp.float32(0.0))
    )


# ---------------------------------------------------------------------------
# Fused-accumulator chunk step: tables stored as [V, D+1] with the Adagrad
# accumulator in the last column. Where it was first profiled the chunk
# step was bound by scattered-row COUNT (a scatter-add cost several times
# the matching gather); carrying (update, gsq) in ONE row per table halves
# both the scatters (4 -> 2) and the gathers (4 -> 2) per step vs the unfused
# SGNSParams layout. Math is bit-identical to the unfused chunk step.
# ---------------------------------------------------------------------------


def _sgns_step_body_chunk_fused(
    tab_in, tab_out,           # [V, D+1] (emb ++ acc column)
    words, cum_len, neg_cdf, keep_prob, lr,
    batch: int, window: int, n_negs: int, key,
):
    D = tab_in.shape[1] - 1
    c_safe, x_safe, valid, k6 = _sample_pair_batch(
        words, cum_len, keep_prob, batch, window, key
    )
    un = jax.random.uniform(k6, (max(1, batch // min(_NEG_CHUNK, batch)),
                                 n_negs * _SHARED_NEG_FACTOR))
    negs_f = jnp.searchsorted(neg_cdf, un).astype(jnp.int32).reshape(-1)

    ids_out = jnp.concatenate([x_safe, negs_f])
    rows_out_f = tab_out[ids_out]             # [M, D+1]
    c_f = tab_in[c_safe]                      # [B, D+1]
    c, acc_c = c_f[:, :D], c_f[:, D]
    rows_out, acc_out = rows_out_f[:, :D], rows_out_f[:, D]
    g_c, g_out, loss, n_valid = _chunk_neg_grads(
        c, rows_out, valid, batch, n_negs
    )

    gsq_c = jnp.mean(g_c**2, axis=1)
    gsq_out = jnp.mean(g_out**2, axis=1)
    scale_c = lr * jax.lax.rsqrt(acc_c + gsq_c + 1e-8)
    scale_out = lr * jax.lax.rsqrt(acc_out + gsq_out + 1e-8)
    upd_in = jnp.concatenate(
        [-scale_c[:, None] * g_c, gsq_c[:, None]], axis=1
    )
    upd_out = jnp.concatenate(
        [-scale_out[:, None] * g_out, gsq_out[:, None]], axis=1
    )
    tab_in = tab_in.at[c_safe].add(upd_in)
    tab_out = tab_out.at[ids_out].add(upd_out)
    return tab_in, tab_out, loss / n_valid.astype(jnp.float32)


@partial(jax.jit, static_argnums=(7, 8, 9, 10))
def sgns_epoch_device_fused(
    tab_in, tab_out, words, cum_len, neg_cdf, keep_prob, lr,
    batch: int, window: int, n_negs: int, n_steps: int, key,
):
    """n_steps fused-accumulator chunk steps in one dispatch."""

    def body(i, carry):
        ti, to, _ = carry
        sub = jax.random.fold_in(key, i)
        return _sgns_step_body_chunk_fused(
            ti, to, words, cum_len, neg_cdf, keep_prob, lr,
            batch, window, n_negs, sub,
        )

    return lax.fori_loop(
        0, n_steps, body, (tab_in, tab_out, jnp.float32(0.0))
    )


def fuse_params(p: SGNSParams):
    """SGNSParams -> ([V, D+1] tab_in, tab_out) with acc as the last col."""
    return (
        jnp.concatenate([p.emb_in, p.acc_in[:, None]], axis=1),
        jnp.concatenate([p.emb_out, p.acc_out[:, None]], axis=1),
    )


def unfuse_params(tab_in, tab_out) -> SGNSParams:
    D = tab_in.shape[1] - 1
    return SGNSParams(
        emb_in=tab_in[:, :D], emb_out=tab_out[:, :D],
        acc_in=tab_in[:, D], acc_out=tab_out[:, D],
    )


# ---------------------------------------------------------------------------
# Model-parallel SGNS: the 1.8M-row embedding tables are the pipeline's one
# genuine model-parallel axis (SURVEY.md §2.2; reference hot loop:
# model/w2vec_aids.py:56-70 runs 16 hogwild threads over one shared table).
# Rows shard over the mesh's model axis; each step's index stream is
# REPLICATED (same rng key on every shard), gathers are psum-of-masked-local
# -gathers (each id owned by exactly one shard, so the psum is exact), and
# updates scatter only into owned rows — bit-identical to the single-device
# chunk step up to the psum's zero-adds.
# ---------------------------------------------------------------------------


def _mp_gather(table_local, ids, v0, vs, axis_name):
    """Replicated [B, D] (or [B]) rows of a row-sharded table."""
    own = (ids >= v0) & (ids < v0 + vs)
    loc = jnp.clip(ids - v0, 0, vs - 1)
    rows = table_local[loc]
    mask = own if rows.ndim == 1 else own[:, None]
    return jax.lax.psum(jnp.where(mask, rows, 0.0), axis_name)


def _mp_scatter_add(table_local, ids, upd, v0, vs):
    """Scatter-add upd rows into the local shard for owned ids (others
    dropped via an out-of-range index)."""
    own = (ids >= v0) & (ids < v0 + vs)
    loc = jnp.where(own, ids - v0, vs)  # vs = out of range -> dropped
    return table_local.at[loc].add(upd, mode="drop")


def _sgns_step_body_mp(
    params_local: SGNSParams,
    words, cum_len, neg_cdf, keep_prob, lr,
    batch: int, window: int, n_negs: int, key, axis_name: str,
):
    """One chunk-mode SGNS step on a row-sharded table (inside shard_map)."""
    vs = params_local.emb_in.shape[0]
    v0 = jax.lax.axis_index(axis_name) * vs
    c_safe, x_safe, valid, k6 = _sample_pair_batch(
        words, cum_len, keep_prob, batch, window, key
    )
    un = jax.random.uniform(k6, (max(1, batch // min(_NEG_CHUNK, batch)),
                                 n_negs * _SHARED_NEG_FACTOR))
    negs_f = jnp.searchsorted(neg_cdf, un).astype(jnp.int32).reshape(-1)

    ids_out = jnp.concatenate([x_safe, negs_f])
    rows_out = _mp_gather(params_local.emb_out, ids_out, v0, vs, axis_name)
    c = _mp_gather(params_local.emb_in, c_safe, v0, vs, axis_name)
    g_c, g_out, loss, n_valid = _chunk_neg_grads(
        c, rows_out, valid, batch, n_negs
    )

    gsq_c = jnp.mean(g_c**2, axis=1)
    gsq_out = jnp.mean(g_out**2, axis=1)
    acc_in_rows = _mp_gather(params_local.acc_in, c_safe, v0, vs, axis_name)
    acc_out_rows = _mp_gather(params_local.acc_out, ids_out, v0, vs, axis_name)
    scale_c = lr * jax.lax.rsqrt(acc_in_rows + gsq_c + 1e-8)
    scale_out = lr * jax.lax.rsqrt(acc_out_rows + gsq_out + 1e-8)
    new = SGNSParams(
        emb_in=_mp_scatter_add(
            params_local.emb_in, c_safe, -scale_c[:, None] * g_c, v0, vs
        ),
        emb_out=_mp_scatter_add(
            params_local.emb_out, ids_out, -scale_out[:, None] * g_out, v0, vs
        ),
        acc_in=_mp_scatter_add(params_local.acc_in, c_safe, gsq_c, v0, vs),
        acc_out=_mp_scatter_add(params_local.acc_out, ids_out, gsq_out, v0, vs),
    )
    return new, loss / n_valid.astype(jnp.float32)


def make_sgns_epoch_mp(
    mesh_ctx, batch: int, window: int, n_negs: int, n_steps: int,
):
    """Jitted model-parallel epoch chunk: params row-sharded over the model
    axis, corpus/cdf replicated, n_steps fused per dispatch (same dispatch
    economics as sgns_epoch_device)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    axis = mesh_ctx.model_axis

    def epoch(params, words, cum_len, neg_cdf, keep_prob, lr, key):
        def body(i, carry):
            p, _ = carry
            return _sgns_step_body_mp(
                p, words, cum_len, neg_cdf, keep_prob, lr,
                batch, window, n_negs, jax.random.fold_in(key, i), axis,
            )

        return lax.fori_loop(0, n_steps, body, (params, jnp.float32(0.0)))

    p_specs = SGNSParams(
        emb_in=P(axis, None), emb_out=P(axis, None),
        acc_in=P(axis), acc_out=P(axis),
    )
    fn = shard_map(
        epoch, mesh=mesh_ctx.mesh,
        in_specs=(p_specs, P(), P(), P(), P(), P(), P()),
        out_specs=(p_specs, P()),
        check_vma=False,
    )
    return jax.jit(fn)


def flat_corpus(
    ev: Events, vocab: Vocab, types
) -> Tuple[np.ndarray, np.ndarray]:
    """Events -> (words [N] int32, cum_len [S+1] int32): the FLAT ragged
    corpus the device sampler consumes (sessions = contiguous runs; OOV
    dropped; length-1 sessions dropped — they emit no pairs). Requires
    events grouped by session (each session's rows contiguous), which the
    pipeline's session-sorted Events guarantee."""
    m = np.isin(ev.type, np.asarray(types, np.int8))
    sess = ev.session[m]
    words = vocab.word_of_aid[ev.aid[m]]
    keep = words >= 0
    sess, words = sess[keep], words[keep]
    if len(words) == 0:
        return np.zeros(0, np.int32), np.zeros(1, np.int32)
    boundary = np.empty(len(sess), bool)
    boundary[0] = True
    np.not_equal(sess[1:], sess[:-1], out=boundary[1:])
    starts = np.flatnonzero(boundary)
    lens = np.diff(np.append(starts, len(sess)))
    keep_run = lens >= 2
    if not keep_run.all():
        words = words[np.repeat(keep_run, lens)]
        lens = lens[keep_run]
    cum = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=cum[1:])
    if cum[-1] > np.iinfo(np.int32).max:
        raise ValueError("corpus exceeds int32 offsets")
    return words.astype(np.int32), cum.astype(np.int32)


def train_word2vec_device(
    ev: Events,
    cfg: Word2VecConfig,
    n_aids: Optional[int] = None,
    max_len: int = 256,   # unused (flat layout); kept for API compat
    checkpoint_path: Optional[str] = None,
    mesh_ctx=None,
) -> Word2Vec:
    """Device-sampled training: the corpus uploads once as a FLAT ragged
    word stream (~4 bytes/event — no padding), every step samples pairs +
    negatives on device (see sgns_step_device_sampled). Preferred at scale.

    With `mesh_ctx` and a model axis > 1, the embedding tables row-shard
    over the model axis (make_sgns_epoch_mp) — the production form of
    SURVEY §2.2's one genuine model-parallel axis. Requires chunk
    negative-sharing (pair mode's dense grads would all-reduce the whole
    table per step)."""
    rng = np.random.default_rng(cfg.seed)
    vocab = build_vocab(ev, cfg.types, cfg.min_count, n_aids)
    if vocab.size == 0:
        raise ValueError("empty vocabulary")
    V = vocab.size

    comp, cum = flat_corpus(ev, vocab, cfg.types)
    lens = np.diff(cum)

    freq = vocab.counts / max(vocab.counts.sum(), 1)
    if cfg.subsample_t > 0:
        keep_prob = np.minimum(
            1.0,
            np.sqrt(cfg.subsample_t / np.maximum(freq, 1e-12))
            + cfg.subsample_t / np.maximum(freq, 1e-12),
        ).astype(np.float32)
    else:
        keep_prob = np.ones(V, np.float32)

    params = init_params(V, cfg.vector_size, cfg.seed)
    neg_cdf = jnp.asarray(make_neg_cdf(vocab.counts, cfg.ns_exponent))
    keep_prob_d = jnp.asarray(keep_prob)
    words_d = jnp.asarray(comp)
    cum_d = jnp.asarray(cum.astype(np.int32))
    key = jax.random.PRNGKey(cfg.seed)

    block_k = int(getattr(cfg, "block_k", 0) or 0)

    total_positions = int(lens.sum())
    steps_per_epoch = max(
        1, total_positions * cfg.window // cfg.batch_size
    )
    neg_mode = getattr(cfg, "neg_sharing", "auto")
    if neg_mode == "auto":
        # pair mode's dense grads stream the whole [V, D] table 3x per
        # step; past ~100k vocab rows (or a corpus big enough that chunk
        # mode's fewer fresh draws stop mattering) the sparse shared-
        # negative step wins by 1-2 orders of magnitude.
        neg_mode = (
            "chunk" if V >= 100_000 or total_positions >= 5_000_000
            else "pair"
        )
        log.info("w2v[device] %s: neg_sharing auto -> %s (V=%d, positions=%d)",
                 cfg.name, neg_mode, V, total_positions)
    start_epoch = 0
    # checkpoint fingerprint: a stale .ckpt in a reused cache dir from a
    # run with a different vocab/dim/config must be discarded, not restored
    # (JAX clamps out-of-range gathers — a vocab mismatch would train on
    # silently-corrupted tables). Validated by load_checkpoint.
    ckpt_meta = {
        "name": cfg.name, "V": V, "vector_size": cfg.vector_size,
        "epochs": cfg.epochs, "seed": cfg.seed,
        "window": cfg.window, "negatives": cfg.negatives,
    }
    if checkpoint_path is not None:
        from otto_tpu.utils.checkpoint import load_checkpoint

        restored = load_checkpoint(
            checkpoint_path, (params, key), expect_meta=ckpt_meta
        )
        if restored is not None:
            (params, key), start_epoch = restored
            log.info("w2v[device] %s resumed at epoch %d", cfg.name, start_epoch)

    # model-parallel setup: pad the row axis to the shard count, shard the
    # tables, keep the index/cdf space at the TRUE V (padded rows are never
    # sampled or gathered, so MP == single-device bit-for-bit)
    n_model = (
        mesh_ctx.mesh.shape[mesh_ctx.model_axis] if mesh_ctx is not None else 1
    )
    mp = n_model > 1
    epoch_mp = None
    if mp:
        if neg_mode != "chunk":
            log.info(
                "w2v[device] %s: model-parallel requires chunk negative "
                "sharing; switching neg_sharing %s -> chunk", cfg.name,
                neg_mode,
            )
            neg_mode = "chunk"
        from jax.sharding import NamedSharding, PartitionSpec as P

        Vp = -(-V // n_model) * n_model
        if Vp != V:
            pad = Vp - V

            def _pad_rows(x, fill=0.0):
                w = ((0, pad),) + ((0, 0),) * (x.ndim - 1)
                return jnp.pad(x, w, constant_values=fill)

            params = SGNSParams(
                _pad_rows(params.emb_in), _pad_rows(params.emb_out),
                _pad_rows(params.acc_in, 1e-6), _pad_rows(params.acc_out, 1e-6),
            )
        rows = NamedSharding(mesh_ctx.mesh, P(mesh_ctx.model_axis))
        rows2 = NamedSharding(
            mesh_ctx.mesh, P(mesh_ctx.model_axis, None)
        )
        params = SGNSParams(
            jax.device_put(params.emb_in, rows2),
            jax.device_put(params.emb_out, rows2),
            jax.device_put(params.acc_in, rows),
            jax.device_put(params.acc_out, rows),
        )

    loss = jnp.float32(0)
    chunk = max(1, int(getattr(cfg, "steps_per_dispatch", 64)))
    if mp:
        epoch_mp = make_sgns_epoch_mp(
            mesh_ctx, cfg.batch_size, cfg.window, cfg.negatives, chunk
        )
    # fused-accumulator layout: a measured negative where it was first
    # tuned — halving the scatter COUNT did not beat the extra
    # concat/slice traffic of [V, D+1] rows. Kept behind an env flag
    # until it is measured on the card (ROADMAP D3).
    fused = (
        (not mp) and neg_mode == "chunk"
        and os.environ.get("OTTO_W2V_FUSED", "0") == "1"
    )
    if fused:
        tab_in, tab_out = fuse_params(params)
        params = None

    # block sampler (round 4 fast path): single-device chunk mode only —
    # MP keeps the per-pair sampler, and pair mode's dense grads make the
    # block layout pointless. batch_size stays the PAIRS-per-step knob.
    block = (
        (not mp) and (not fused) and neg_mode == "chunk" and block_k > 1
        and os.environ.get("OTTO_W2V_BLOCK", "1") != "0"
    )
    opt = str(getattr(cfg, "optimizer", "adagrad"))
    # round centers up to a whole number of negative-pool chunks so the
    # step's [Nc, centers-per-chunk] blocking always divides exactly
    _cpc = max(1, _NEG_CHUNK // max(block_k, 1))
    n_centers = -(-max(1, cfg.batch_size // max(block_k, 1)) // _cpc) * _cpc
    if block:
        neg_prob_np, neg_alias_np = make_alias(vocab.counts, cfg.ns_exponent)
        neg_prob_d = jnp.asarray(neg_prob_np)
        neg_alias_d = jnp.asarray(neg_alias_np)
        pos_info_d = jnp.asarray(pack_position_info(cum))
        log.info(
            "w2v[device] %s: block sampler on (%d centers x k=%d)",
            cfg.name, n_centers, block_k,
        )
    for epoch in range(start_epoch, cfg.epochs):
        key, sub = jax.random.split(key)
        # epoch = a host loop of fixed-size fused dispatches: one dispatch
        # per `chunk` steps (Word2VecConfig.steps_per_dispatch), and the
        # fixed size keeps ONE compiled program. The last dispatch runs a
        # full chunk — the
        # step target is a sampling heuristic, slight overshoot is fine.
        n_chunks = max(1, (steps_per_epoch + chunk - 1) // chunk)
        for c in range(n_chunks):
            sub_c = jax.random.fold_in(sub, c)
            if mp:
                params, loss = epoch_mp(
                    params, words_d, cum_d, neg_cdf, keep_prob_d,
                    jnp.float32(cfg.learning_rate), sub_c,
                )
            elif fused:
                tab_in, tab_out, loss = sgns_epoch_device_fused(
                    tab_in, tab_out, words_d, cum_d, neg_cdf, keep_prob_d,
                    jnp.float32(cfg.learning_rate),
                    cfg.batch_size, cfg.window, cfg.negatives, chunk, sub_c,
                )
            elif block:
                if opt == "sgd":
                    # gensim's linear alpha -> min_alpha sweep across the
                    # whole training run. ABSOLUTE epoch indices: a resumed
                    # run must continue the original decay, not restart it
                    # over the remaining epochs
                    done = epoch * n_chunks + c
                    total = max(1, cfg.epochs * n_chunks)
                    a0 = float(getattr(cfg, "sgd_alpha", 0.025))
                    a1 = float(getattr(cfg, "sgd_min_alpha", 1e-4))
                    lr_t = jnp.float32(a0 + (a1 - a0) * (done / total))
                else:
                    lr_t = jnp.float32(cfg.learning_rate)
                params, loss = sgns_epoch_device_block(
                    params, words_d, pos_info_d, neg_prob_d, neg_alias_d,
                    keep_prob_d, lr_t,
                    n_centers, block_k, cfg.window, cfg.negatives, chunk,
                    sub_c, opt,
                )
            else:
                params, loss = sgns_epoch_device(
                    params, words_d, cum_d, neg_cdf, keep_prob_d,
                    jnp.float32(cfg.learning_rate),
                    cfg.batch_size, cfg.window, cfg.negatives, chunk,
                    sub_c, neg_mode,
                )
        log.info("w2v[device] %s epoch %d: %d steps (%d dispatches), loss=%.4f",
                 cfg.name, epoch, n_chunks * chunk, n_chunks, float(loss))
        # Saves are opt-in (OTTO_W2V_CKPT_EVERY=N epochs): each one pulls
        # the [V, D] tables and accumulators to the host and writes them,
        # which may cost more than re-running the epochs a rare crash
        # loses (unmeasured on the card; ROADMAP D2). Resume (above)
        # always honours an existing checkpoint.
        ckpt_every = int(os.environ.get("OTTO_W2V_CKPT_EVERY", "0") or 0)
        if (
            checkpoint_path is not None
            and ckpt_every > 0
            and (epoch + 1) % ckpt_every == 0
            and epoch + 1 < cfg.epochs  # final state persists as the .npz
        ):
            from otto_tpu.utils.checkpoint import save_checkpoint

            # device-independent state: slice tables back to the TRUE V
            # before saving — under model parallelism params are padded to
            # Vp rows and saving those re-padded on resume ([2*Vp-V, D]
            # tables with wrong row->shard mapping). The resume
            # template is unpadded [V, ...], so the MP branch re-pads and
            # re-shards the restored state correctly.
            state_params = unfuse_params(tab_in, tab_out) if fused else params
            state_params = jax.tree_util.tree_map(
                lambda x: x[:V], state_params
            )
            save_checkpoint(
                checkpoint_path, (state_params, key), epoch + 1,
                meta=ckpt_meta,
            )

    if fused:
        emb = np.asarray(tab_in[:, : cfg.vector_size])
    else:
        emb = np.asarray(params.emb_in)[:V, : cfg.vector_size]
    return Word2Vec(cfg, vocab, emb)


def train_word2vec(
    ev: Events,
    cfg: Word2VecConfig,
    n_aids: Optional[int] = None,
    callback=None,
) -> Word2Vec:
    """Full training loop (reference: model/w2vec_aids.py:56-70)."""
    rng = np.random.default_rng(cfg.seed)
    vocab = build_vocab(ev, cfg.types, cfg.min_count, n_aids)
    if vocab.size == 0:
        raise ValueError("empty vocabulary")
    V = vocab.size
    D = cfg.vector_size
    params = init_params(V, D, cfg.seed)
    neg_cdf = jnp.asarray(make_neg_cdf(vocab.counts, cfg.ns_exponent))
    key = jax.random.PRNGKey(cfg.seed)

    total_steps = 0
    # count steps for lr schedule: pairs per epoch is data dependent; estimate
    # from epoch 0 lazily by generating pairs per epoch.
    for epoch in range(cfg.epochs):
        c, x = skipgram_pairs(
            ev, vocab, cfg.types, cfg.window, cfg.subsample_t, rng
        )
        n_steps = max(1, len(c) // cfg.batch_size)
        for i in range(n_steps):
            sl = slice(i * cfg.batch_size, (i + 1) * cfg.batch_size)
            cb, xb = c[sl], x[sl]
            if len(cb) < cfg.batch_size:  # pad to static shape
                pad = cfg.batch_size - len(cb)
                cb = np.concatenate([cb, np.zeros(pad, np.int32)])
                xb = np.concatenate([xb, np.zeros(pad, np.int32)])
            frac = (epoch + i / n_steps) / cfg.epochs
            lr = jnp.float32(
                cfg.learning_rate
                + (cfg.min_learning_rate - cfg.learning_rate) * frac
            )
            key, sub = jax.random.split(key)
            params, loss = sgns_step(
                params, jnp.asarray(cb), jnp.asarray(xb), neg_cdf, lr, sub,
                cfg.negatives,
            )
            total_steps += 1
        if callback is not None:
            callback(epoch, float(loss))
        log.info("w2v %s epoch %d: %d pairs, loss=%.4f", cfg.name, epoch, len(c), float(loss))

    emb = np.asarray(params.emb_in)[:, : cfg.vector_size]
    return Word2Vec(cfg, vocab, emb)
