"""LambdaRank scoring tower (C16/C17).

Replaces LightGBM's lambdarank GBDT (reference: config.py:207-227,
model/train_lgbm_rankers.py:110-129) with an MLP scoring tower trained with
the LambdaRank pairwise loss over per-session candidate groups — the one
intentional model-class change (BASELINE north star: a batched pairwise
tower is pure matmul work). The pipeline's default ranker is the GBDT
(models/gbdt.py); this tower is the alternative backend (ROADMAP D6).

Semantics kept from the reference:
  * listwise groups = sessions, one group per session
    (reference: model/train_lgbm_rankers.py:56 group_counts)
  * objective = lambdarank with |dNDCG@20| pair weights
    (reference: config.py:207-227 'lambdarank', eval_at [20])
  * per-target models: clicks / carts / orders trained independently
  * feature set = all retrieval feature columns
    (reference: model/train_lgbm_rankers.py:38-40)

Data parallel: one session group never crosses a device boundary, so dp
sharding over the batch axis + psum of grads is exact.
"""
from __future__ import annotations

import dataclasses
import logging
from functools import partial
from typing import Iterator, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from otto_tpu.config import RankerConfig

log = logging.getLogger(__name__)


class RankerParams(NamedTuple):
    norm_mean: jnp.ndarray   # [F]
    norm_std: jnp.ndarray    # [F]
    weights: Tuple           # tuple of (W, b) per layer
    # [n_src] feature indices of the src_* flags, or None. When set, the
    # tower scores LISTWISE: the axis before F is the candidate group and
    # the input is augmented with group-relative context (x - mean_g,
    # x - max_g over valid candidates; validity = any src flag set). An
    # independent per-candidate MLP cannot express "best in its session" —
    # LightGBM's session-wise splits can, and this closes most of that gap
    # on the 20k-session synthetic sweep.
    src_idx: "jnp.ndarray | None" = None


def _log_squash(x: jnp.ndarray) -> jnp.ndarray:
    """Sign-preserving log compression for heavy-tailed count/ts features."""
    return jnp.sign(x) * jnp.log1p(jnp.abs(x))


def init_ranker(
    n_features: int,
    cfg: RankerConfig,
    feat_mean: np.ndarray,
    feat_std: np.ndarray,
    seed: Optional[int] = None,
    src_idx: Optional[np.ndarray] = None,
) -> RankerParams:
    key = jax.random.PRNGKey(cfg.seed if seed is None else seed)
    in_dim = n_features * (3 if src_idx is not None else 1)
    dims = [in_dim, *cfg.hidden_dims, 1]
    weights = []
    for i in range(len(dims) - 1):
        key, sub = jax.random.split(key)
        w = jax.random.normal(sub, (dims[i], dims[i + 1])) * jnp.sqrt(
            2.0 / dims[i]
        )
        b = jnp.zeros((dims[i + 1],))
        weights.append((w, b))
    return RankerParams(
        norm_mean=jnp.asarray(feat_mean, jnp.float32),
        norm_std=jnp.asarray(feat_std, jnp.float32),
        weights=tuple(weights),
        src_idx=None if src_idx is None else jnp.asarray(src_idx, jnp.int32),
    )


def score(
    params: RankerParams,
    feats: jnp.ndarray,
    dropout: float = 0.0,
    key: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """feats [..., F] -> scores [...]. bf16 matmuls, f32 accumulation.
    `dropout` > 0 (training only) drops hidden activations with inverted
    scaling; inference calls leave it at 0.

    With params.src_idx set, the axis before F is the candidate GROUP and
    the input is augmented listwise: [x, x - mean_g(x), x - max_g(x)] over
    the group's valid candidates (validity = any src_* flag set — padding
    rows are all-zero there by the retrieval null-fill contract)."""
    x = (_log_squash(feats) - params.norm_mean) / params.norm_std
    if params.src_idx is not None:
        valid = jnp.sum(feats[..., params.src_idx] > 0, axis=-1) > 0  # [..., G]
        vf = valid[..., None].astype(jnp.float32)
        n_valid = jnp.maximum(jnp.sum(vf, axis=-2, keepdims=True), 1.0)
        g_mean = jnp.sum(x * vf, axis=-2, keepdims=True) / n_valid
        g_max = jnp.max(
            jnp.where(vf > 0, x, -jnp.inf), axis=-2, keepdims=True
        )
        g_max = jnp.where(jnp.isfinite(g_max), g_max, 0.0)
        x = jnp.concatenate([x, x - g_mean, x - g_max], axis=-1)
    x = x.astype(jnp.bfloat16)
    n = len(params.weights)
    for i, (w, b) in enumerate(params.weights):
        x = (
            jnp.dot(x, w.astype(jnp.bfloat16), preferred_element_type=jnp.float32)
            + b
        )
        if i < n - 1:
            x = jax.nn.relu(x)
            if dropout > 0.0 and key is not None:
                key, sub = jax.random.split(key)
                keep = jax.random.bernoulli(sub, 1.0 - dropout, x.shape)
                x = jnp.where(keep, x / (1.0 - dropout), 0.0)
            x = x.astype(jnp.bfloat16)
    return x[..., 0]


_score_jit = jax.jit(score)


def compute_norm_stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Feature normalization stats over a training sample (after log squash)."""
    # f32 up-cast first: half-precision inputs (e.g. compacted feature
    # caches) overflow both np.abs on ±inf rows and f16-accumulated means
    x = np.asarray(feats, np.float32)
    x = np.sign(x) * np.log1p(np.abs(x))
    mean = x.mean(axis=0)
    std = x.std(axis=0)
    std = np.where(std < 1e-6, 1.0, std)
    return mean.astype(np.float32), std.astype(np.float32)


def _lambdarank_loss(
    params: RankerParams,
    feats: jnp.ndarray,    # [B, G, F]
    labels: jnp.ndarray,   # [B, G] float 0/1
    mask: jnp.ndarray,     # [B, G] bool
    sigma: float,
    k: int,
    dropout: float = 0.0,
    key: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    s = score(params, feats, dropout, key)         # [B, G]
    s = jnp.where(mask, s, -1e9)
    G = s.shape[1]

    # current rank of each candidate (0-based) via double argsort
    order = jnp.argsort(-s, axis=1)
    rank = jnp.zeros_like(order).at[
        jnp.arange(s.shape[0])[:, None], order
    ].set(jnp.arange(G)[None, :])

    disc = jnp.where(rank < k, 1.0 / jnp.log2(2.0 + rank.astype(jnp.float32)), 0.0)

    # ideal DCG@k: positives ranked first
    n_pos = jnp.sum(labels * mask, axis=1)
    ideal_pos = jnp.arange(G, dtype=jnp.float32)[None, :]
    ideal_disc = jnp.where(
        (ideal_pos < jnp.minimum(n_pos, k)[:, None]),
        1.0 / jnp.log2(2.0 + ideal_pos),
        0.0,
    )
    max_dcg = jnp.maximum(jnp.sum(ideal_disc, axis=1), 1e-9)  # [B]

    y = jnp.where(mask, labels, 0.0)
    pair_pos = (y[:, :, None] > y[:, None, :]) & mask[:, :, None] & mask[:, None, :]
    delta_ndcg = jnp.abs(disc[:, :, None] - disc[:, None, :]) / max_dcg[:, None, None]
    s_diff = s[:, :, None] - s[:, None, :]
    pair_loss = jax.nn.softplus(-sigma * s_diff) * delta_ndcg
    loss = jnp.sum(jnp.where(pair_pos, pair_loss, 0.0))
    n_pairs = jnp.maximum(jnp.sum(pair_pos), 1.0)
    return loss / n_pairs


@partial(jax.jit, static_argnums=(4, 5, 6, 7))
def train_step(
    params: RankerParams,
    opt_state,
    batch: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
    key,
    optimizer,
    sigma: float,
    k: int,
    dropout: float = 0.0,
):
    feats, labels, mask = batch

    # differentiate the layer weights ONLY: norm stats are constants and
    # src_idx is an int32 index table (grad rejects integer leaves)
    def loss_of_weights(weights):
        return _lambdarank_loss(
            params._replace(weights=weights), feats, labels, mask,
            sigma, k, dropout, key,
        )

    loss, gw = jax.value_and_grad(loss_of_weights)(params.weights)
    updates, opt_state = optimizer.update(gw, opt_state, params.weights)
    params = params._replace(
        weights=optax.apply_updates(params.weights, updates)
    )
    return params, opt_state, loss


def ndcg_at_k(
    scores: np.ndarray, labels: np.ndarray, mask: np.ndarray, k: int = 20
) -> float:
    """Mean NDCG@k over groups with at least one positive (the LightGBM
    eval metric, reference: config.py:210 'ndcg', PARAMS_LGBM_FIT eval_at)."""
    s = np.where(mask, scores, -np.inf)
    y = np.where(mask, labels, 0.0)
    k = min(k, s.shape[1])
    order = np.argsort(-s, axis=1)[:, :k]
    top_y = np.take_along_axis(y, order, axis=1)
    disc = 1.0 / np.log2(2.0 + np.arange(k))
    dcg = (top_y * disc[None, :]).sum(axis=1)
    n_pos = y.sum(axis=1).astype(np.int64)
    has_pos = n_pos > 0
    ideal = np.array(
        [disc[: min(n, k)].sum() if n > 0 else 1.0 for n in n_pos]
    )
    return float((dcg[has_pos] / ideal[has_pos]).mean()) if has_pos.any() else 0.0


@dataclasses.dataclass
class Ranker:
    """Trained per-target ranker (LGBM booster analogue)."""

    cfg: RankerConfig
    params: RankerParams
    feature_names: Tuple[str, ...]

    def predict_scores_device(self, feats: jnp.ndarray) -> jnp.ndarray:
        """Device-resident scoring: feats [..., F] on device -> scores [...]
        with NO host round-trip (the np predict() below pulls the feature
        tensor through the host link — ~100 MB/batch on retrieval output)."""
        return _score_jit(self.params, feats.astype(jnp.float32))

    def predict(self, feats: np.ndarray, batch: int = 1 << 16) -> np.ndarray:
        if self.params.src_idx is not None:
            raise ValueError(
                "group-context ranker scores listwise; use predict_grouped"
                " with [n_groups, group, F] input"
            )
        out = np.empty(feats.shape[0], np.float32)
        for i in range(0, feats.shape[0], batch):
            out[i : i + batch] = np.asarray(
                score(self.params, jnp.asarray(feats[i : i + batch], jnp.float32))
            )
        return out

    def predict_grouped(self, feats: np.ndarray, batch: int = 1 << 12) -> np.ndarray:
        """[n_groups, G, F] -> [n_groups, G] scores (host driver)."""
        out = np.empty(feats.shape[:2], np.float32)
        for i in range(0, feats.shape[0], batch):
            out[i : i + batch] = np.asarray(
                score(self.params, jnp.asarray(feats[i : i + batch], jnp.float32))
            )
        return out

    def save(self, path: str) -> None:
        flat = {"norm_mean": np.asarray(self.params.norm_mean),
                "norm_std": np.asarray(self.params.norm_std),
                "feature_names": np.array(self.feature_names)}
        if self.params.src_idx is not None:
            flat["src_idx"] = np.asarray(self.params.src_idx)
        for i, (w, b) in enumerate(self.params.weights):
            flat[f"w{i}"] = np.asarray(w)
            flat[f"b{i}"] = np.asarray(b)
        np.savez_compressed(path, **flat)

    @staticmethod
    def load(path: str, cfg: RankerConfig) -> "Ranker":
        z = np.load(path, allow_pickle=False)
        n_layers = len([k for k in z.files if k.startswith("w")])
        weights = tuple(
            (jnp.asarray(z[f"w{i}"]), jnp.asarray(z[f"b{i}"]))
            for i in range(n_layers)
        )
        params = RankerParams(
            jnp.asarray(z["norm_mean"]), jnp.asarray(z["norm_std"]), weights,
            jnp.asarray(z["src_idx"]) if "src_idx" in z.files else None,
        )
        return Ranker(cfg, params, tuple(z["feature_names"].tolist()))


def train_ranker(
    feats: np.ndarray,      # [N, F] flat candidate rows
    labels: np.ndarray,     # [N] 0/1 target for ONE type
    group_sessions: np.ndarray,  # [N] session id per row (sorted)
    feature_names: Tuple[str, ...],
    cfg: RankerConfig,
    valid: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
) -> Ranker:
    """Group rows by session, pad groups to cfg.max_group, train.

    Training loop: linear-warmup + cosine-decay lr,
    train-time dropout, per-epoch valid ndcg@k with best-epoch tracking and
    optional early stopping — the LightGBM-side equivalents the reference
    relies on (best-iter extraction reference: utils.py:77-93, eval logs
    every 25 iters reference: config.py:223-227)."""
    feats = np.asarray(feats, np.float32)
    mean, std = compute_norm_stats(feats[: 1 << 20])
    src_idx = None
    if getattr(cfg, "group_context", True):
        src_idx = np.asarray(
            [i for i, n in enumerate(feature_names) if n.startswith("src_")],
            np.int32,
        )
        if len(src_idx) == 0:
            src_idx = None
    params = init_ranker(feats.shape[1], cfg, mean, std, src_idx=src_idx)

    fg, lg, mg = _group_pad(feats, labels, group_sessions, cfg.max_group)
    n_groups = fg.shape[0]
    rng = np.random.default_rng(cfg.seed)
    key = jax.random.PRNGKey(cfg.seed)
    # fewer groups than the configured batch => shrink the batch, otherwise
    # the epoch loop below would run zero steps and train nothing
    B = min(cfg.batch_sessions, n_groups)
    steps_per_epoch = max(1, n_groups // B)
    total_steps = steps_per_epoch * cfg.epochs
    warmup = max(1, int(total_steps * getattr(cfg, "warmup_frac", 0.05)))
    schedule = optax.warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=cfg.learning_rate,
        warmup_steps=warmup,
        decay_steps=total_steps,
        end_value=cfg.learning_rate * getattr(cfg, "end_lr_frac", 0.05),
    )
    optimizer = optax.adamw(schedule, weight_decay=cfg.weight_decay)
    opt_state = optimizer.init(params.weights)

    vpack = None
    if valid is not None:
        vf, vl, vs = valid
        vfg, vlg, vmg = _group_pad(
            np.asarray(vf, np.float32), vl, vs, cfg.max_group
        )
        vpack = (vfg, vlg, vmg, vf.shape[1])

    es = int(getattr(cfg, "early_stop_epochs", 0) or 0)
    best_ndcg, best_params, best_epoch = -1.0, None, -1
    loss = jnp.float32(0)
    for epoch in range(cfg.epochs):
        perm = rng.permutation(n_groups)
        for i in range(0, n_groups - B + 1, B):
            sel = perm[i : i + B]
            key, sub = jax.random.split(key)
            params, opt_state, loss = train_step(
                params,
                opt_state,
                (
                    jnp.asarray(fg[sel], jnp.float32),
                    jnp.asarray(lg[sel], jnp.float32),
                    jnp.asarray(mg[sel]),
                ),
                sub,
                optimizer,
                cfg.sigma,
                cfg.eval_at,
                float(cfg.dropout),
            )
        msg = f"ranker epoch {epoch}: loss={float(loss):.5f}"
        if vpack is not None:
            vfg, vlg, vmg, Fv = vpack
            r = Ranker(cfg, params, feature_names)
            vscores = r.predict_grouped(vfg)
            vndcg = ndcg_at_k(vscores, vlg, vmg, cfg.eval_at)
            msg += f" valid ndcg@{cfg.eval_at}={vndcg:.5f}"
            if vndcg > best_ndcg:
                best_ndcg, best_epoch = vndcg, epoch
                best_params = jax.tree.map(np.asarray, params)
            elif es and epoch - best_epoch >= es:
                log.info("%s (early stop; best epoch %d ndcg %.5f)",
                         msg, best_epoch, best_ndcg)
                break
        log.info(msg)
    if best_params is not None:
        params = jax.tree.map(jnp.asarray, best_params)

    return Ranker(cfg, params, feature_names)


def _group_pad(feats, labels, sessions, max_group):
    """[N, F] rows -> [n_groups, max_group, F] padded groups by session.
    Vectorized; when truncating a group, positives sort first so the
    supervision signal is never dropped."""
    # order rows by (session, -label): positives lead each group
    order = np.lexsort((-labels, sessions))
    s_s, l_s, f_s = sessions[order], labels[order], feats[order]
    u_sess, starts = np.unique(s_s, return_index=True)
    n_g = len(u_sess)
    gi = np.searchsorted(u_sess, s_s)
    pos = np.arange(len(s_s)) - starts[gi]
    keep = pos < max_group
    F = feats.shape[1]
    # keep the caller's feature dtype (uint8 bins / f16 caches pad as-is —
    # padding a 4x-bigger f32 copy was pure host + link waste)
    fdt = feats.dtype if feats.dtype in (np.uint8, np.float16) else np.float32
    fg = np.zeros((n_g, max_group, F), fdt)
    lg = np.zeros((n_g, max_group), np.float32)
    mg = np.zeros((n_g, max_group), bool)
    fg[gi[keep], pos[keep]] = f_s[keep]
    lg[gi[keep], pos[keep]] = l_s[keep]
    mg[gi[keep], pos[keep]] = True
    return fg, lg, mg
