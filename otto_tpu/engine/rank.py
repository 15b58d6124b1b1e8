"""Negative downsampling, scoring, and top-k selection (C15, C17).

Downsampling (reference: model/downsample_retrieved.py:37-62): per target
type drop sessions without positives, keep at most
min(neg_to_pos_ratio * n_pos, max_neg_per_session) negatives per session
(seeded shuffle).

Scoring (reference: model/rank.py:46-59): score every retrieved candidate
with the target's ranker, ordinal-rank scores desc per session, keep top-k.
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from otto_tpu.config import RankerConfig
from otto_tpu.engine.retrieval import RetrievedBatch
from otto_tpu.models.ranker import Ranker


def downsample_select(
    b: RetrievedBatch,
    tgt: np.ndarray,                # [S, C, 3]
    type_id: int,
    cfg: RankerConfig,
    rng: np.random.Generator,
) -> "Tuple[np.ndarray, np.ndarray, np.ndarray] | None":
    """Selection half of the downsampler (host-only): returns row indices
    (si, ci) plus labels, or None when no session in the batch has a
    positive. Consumes rng draws only in the positive case, so feeding
    batches through per-type rng streams reproduces the all-at-once
    `downsample` selection exactly."""
    S, C = b.cand.shape
    valid = b.cand >= 0
    y = tgt[:, :, type_id]
    n_pos = (y * valid).sum(axis=1)
    keep_sessions = n_pos > 0
    if not keep_sessions.any():
        return None
    max_neg = np.minimum(
        n_pos * cfg.neg_to_pos_ratio, cfg.max_neg_per_session
    )
    # random priority per negative; keep the max_neg smallest
    prio = rng.random((S, C))
    neg_mask = valid & (y == 0)
    # rank of each negative within its session by priority
    order = np.argsort(np.where(neg_mask, prio, 2.0), axis=1, kind="stable")
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.arange(C)[None, :].repeat(S, 0), axis=1)
    keep_neg = neg_mask & (rank < max_neg[:, None])
    keep = (valid & (y > 0)) | keep_neg
    keep &= keep_sessions[:, None]
    si, ci = np.nonzero(keep)
    return si, ci, y[si, ci]


def downsample_batch(
    b: RetrievedBatch,
    tgt: np.ndarray,                # [S, C, 3]
    type_id: int,
    cfg: RankerConfig,
    rng: np.random.Generator,
) -> "Tuple[np.ndarray, np.ndarray, np.ndarray] | None":
    """One batch of the downsampler -> (feats, labels, sessions) flat rows.
    Device-side row gather: only the selected rows cross the link."""
    got = downsample_select(b, tgt, type_id, cfg, rng)
    if got is None:
        return None
    si, ci, y = got
    return b.feats_rows(si, ci), y, b.session[si]


def downsample(
    batches: List[RetrievedBatch],
    targets: List[np.ndarray],      # [S, C, 3] aligned with batches
    type_id: int,
    cfg: RankerConfig,
    seed: int = 42,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (feats [N, F], labels [N], sessions [N]) flat rows, session-sorted."""
    rng = np.random.default_rng(seed)
    feats_out, lab_out, sess_out = [], [], []
    for b, tgt in zip(batches, targets):
        got = downsample_batch(b, tgt, type_id, cfg, rng)
        if got is None:
            continue
        feats_out.append(got[0])
        lab_out.append(got[1])
        sess_out.append(got[2])
    if not feats_out:
        raise ValueError(f"no positive sessions for type {type_id}")
    feats = np.concatenate(feats_out)
    labels = np.concatenate(lab_out)
    sessions = np.concatenate(sess_out)
    order = np.argsort(sessions, kind="stable")
    return feats[order], labels[order], sessions[order]


@partial(jax.jit, static_argnums=(2,))
def _topk_program(scores: jnp.ndarray, cand: jnp.ndarray, k: int):
    s = jnp.where(cand >= 0, scores, -jnp.inf)
    top_s, idx = jax.lax.top_k(s, k)
    top_a = jnp.take_along_axis(cand, idx, axis=1)
    return top_s, jnp.where(jnp.isfinite(top_s), top_a, -1)


def _score_batch_device(b: RetrievedBatch, ranker, top_k: int):
    """Score + top-k fully on device; only [S, k] crosses the host link.

    Batch contract (engine.retrieval.iter_run): feats arrive KEEP-FILTERED
    to the real sessions; cand_device() applies the same filter, so both
    are [n_keep, C]-aligned. Batches pad to a power-of-two session count
    so the compiled predict/top-k program set stays tiny (the reference
    scores ~the whole retrieved set on CPU for ~60 min, model/rank.py:27;
    here the [S, C, F] feature tensors never leave the device)."""
    S, C = b.feats.shape[:2]
    Sp = max(8, 1 << (S - 1).bit_length())
    feats = b.feats
    cand = b.cand_device()   # keep-filtered like feats: no host round-trip
    if Sp != S:
        feats = jnp.pad(feats, ((0, Sp - S), (0, 0), (0, 0)))
        cand = jnp.pad(cand, ((0, Sp - S), (0, 0)), constant_values=-1)
    scores = ranker.predict_scores_device(feats)
    top_s, top_a = _topk_program(scores, cand, top_k)
    return np.asarray(top_s)[:S], np.asarray(top_a)[:S]


def score_topk_multi(
    b: RetrievedBatch, rankers: List, top_k: int = 20
) -> Optional[np.ndarray]:
    """Score ONE batch with ALL rankers on device; pull a single stacked
    [T, S, k] aid tensor (one device->host pull per batch instead of two
    per target). Returns None when the device fast path does not
    apply."""
    if not (
        isinstance(b.feats, jnp.ndarray)
        and all(hasattr(r, "predict_scores_device") for r in rankers)
    ):
        return None
    S, C = b.feats.shape[:2]
    Sp = max(8, 1 << (S - 1).bit_length())
    feats = b.feats
    cand = b.cand_device()
    if Sp != S:
        feats = jnp.pad(feats, ((0, Sp - S), (0, 0), (0, 0)))
        cand = jnp.pad(cand, ((0, Sp - S), (0, 0)), constant_values=-1)
    tops = []
    for r in rankers:
        scores = r.predict_scores_device(feats)
        tops.append(_topk_program(scores, cand, top_k)[1])
    return np.asarray(jnp.stack(tops))[:, :S]         # ONE pull


def score_and_topk(
    batches: List[RetrievedBatch],
    ranker: Ranker,
    top_k: int = 20,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (sessions [N], top-k aids [N, k] rank-ordered, scores [N, k])."""
    sess_out, aid_out, score_out = [], [], []
    for b in batches:
        if isinstance(b.feats, jnp.ndarray) and hasattr(
            ranker, "predict_scores_device"
        ):
            top_score, top_aid = _score_batch_device(b, ranker, top_k)
            sess_out.append(b.session)
            aid_out.append(top_aid)
            score_out.append(top_score)
            continue
        S, C = b.cand.shape
        # feats arrive keep-filtered (iter_run contract), aligned with cand
        feats_np = np.asarray(b.feats, np.float32)
        if getattr(getattr(ranker, "params", None), "src_idx", None) is not None:
            # listwise (group-context) tower: keep the candidate-group axis
            scores = ranker.predict_grouped(feats_np)
        else:
            scores = ranker.predict(
                feats_np.reshape(-1, feats_np.shape[-1])
            ).reshape(S, C)
        scores = np.where(b.cand >= 0, scores, -np.inf)
        order = np.argsort(-scores, axis=1, kind="stable")[:, :top_k]
        top_aid = np.take_along_axis(b.cand, order, axis=1)
        top_score = np.take_along_axis(scores, order, axis=1)
        top_aid = np.where(np.isfinite(top_score), top_aid, -1)
        sess_out.append(b.session)
        aid_out.append(top_aid)
        score_out.append(top_score)
    sessions = np.concatenate(sess_out)
    aids = np.concatenate(aid_out)
    scores = np.concatenate(score_out)
    order = np.argsort(sessions, kind="stable")
    return sessions[order], aids[order], scores[order]


def write_submission(
    path: str,
    preds_by_type: dict,   # type name -> (sessions [N], aids [N, k])
) -> None:
    """Kaggle CSV `session_type,labels` (reference: model/submit.py:45-61)."""
    with open(path, "w") as fh:
        fh.write("session_type,labels\n")
        rows = []
        for tname, (sessions, aids) in preds_by_type.items():
            for s, row in zip(sessions, aids):
                labels = " ".join(str(int(a)) for a in row if a >= 0)
                rows.append((f"{int(s)}_{tname}", labels))
        rows.sort()
        for st, labels in rows:
            fh.write(f"{st},{labels}\n")


def read_submission(path: str) -> dict:
    """Parse back a submission CSV (reference: model/eval_submission.py:34-42)."""
    out = {}
    with open(path) as fh:
        next(fh)
        for line in fh:
            st, labels = line.rstrip("\n").split(",", 1)
            s, tname = st.rsplit("_", 1)
            aids = [int(a) for a in labels.split()] if labels else []
            out.setdefault(tname, {})[int(s)] = aids
    return out
