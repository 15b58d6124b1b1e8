"""Configuration registry for the otto_tpu engine.

Mirrors the semantics of the reference constants module (reference:
config.py:1-227) but as typed, overridable dataclasses instead of a flat
module of globals. Every constant that shapes an algorithm (time windows,
count thresholds, retrieval caps, model hyper-parameters) is kept
name-compatible so parity against the reference tables can be checked
line by line.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from pathlib import Path
from typing import Dict, List, Tuple

# ---------------------------------------------------------------------------
# Event types (reference: config.py:35-36)
# ---------------------------------------------------------------------------
TYPES: List[str] = ["clicks", "carts", "orders"]
TYPE2ID: Dict[str, int] = {"clicks": 0, "carts": 1, "orders": 2}
ID2TYPE: Dict[int, str] = {v: k for k, v in TYPE2ID.items()}

# Weighted recall weights (reference: model/eval_submission.py:55)
TYPE_WEIGHTS: Dict[str, float] = {"clicks": 0.1, "carts": 0.3, "orders": 0.6}

# Submission cutoff (reference: config.py:31)
KEEP_TOP_K = 20

HOUR = 60 * 60
DAY = 24 * HOUR


@dataclasses.dataclass(frozen=True)
class CoVisConfig:
    """Co-visitation counting parameters (reference: config.py:38-104)."""

    # Pair time-window filter applied at self-merge time
    # (reference: config.py:41-42).
    min_time_to_next: int = -DAY
    max_time_to_next: int = DAY

    # Per count-type |dt| cap (reference: config.py:43-49).
    max_time_to_next_by_type: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {
            "click_to_click": 12 * HOUR,
            "click_to_cart_or_buy": DAY,
            "cart_to_cart": DAY,
            "cart_to_buy": DAY,
            "buy_to_buy": DAY,
        }
    )

    # (type_this, types_next) per count type (reference: config.py:81-88).
    count_types: Dict[str, Tuple[int, Tuple[int, ...]]] = dataclasses.field(
        default_factory=lambda: {
            "click_to_click": (0, (0,)),
            "click_to_cart_or_buy": (0, (1, 2)),
            "cart_to_cart": (1, (1,)),
            "cart_to_buy": (1, (2,)),
            "buy_to_buy": (2, (2,)),
        }
    )

    # Global min count for a pair to be kept (reference: config.py:56-62).
    min_count_to_save: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {
            "click_to_click": 10,
            "click_to_cart_or_buy": 5,
            "cart_to_cart": 2,
            "cart_to_buy": 2,
            "buy_to_buy": 2,
        }
    )
    # Min count applied to partial aggregates during the hierarchical merge
    # (reference: config.py:63).
    min_count_in_part: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"click_to_click": 2, "click_to_cart_or_buy": 2}
    )
    # Hard cap on pairs kept per matrix (reference: config.py:64).
    max_pairs_to_save: int = 300_000_000

    # Top-N co-visit neighbours used at retrieval time
    # (reference: config.py:90-96).
    retrieval_first_n: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {
            "click_to_click": 10,
            "click_to_cart_or_buy": 10,
            "cart_to_cart": 20,
            "cart_to_buy": 20,
            "buy_to_buy": 20,
        }
    )

    # Device-side accumulator capacity (pairs) before a hierarchical merge is
    # forced. Device analogue of MAX_ROWS_POLARS_GROUPBY (reference: config.py:52-53).
    accumulator_capacity: int = 1 << 23

    # Reference-capacity counting: fully-merged device runs spill LOSSLESSLY
    # to host RAM and the global merge + prune happen there (the 300M-pair
    # matrices, reference config.py:64, are held out of core, as the
    # reference holds them; whether they fit on an 80 GB card is ROADMAP
    # D5). False keeps the device-only
    # bounded top table (accumulator_capacity pairs/type, in-part overflow
    # pruning) — exact only while counts fit on device.
    host_spill: bool = True

    # Spill-time in-part pruning: a fully-merged run about to spill drops
    # pairs with count < min_count_in_part[type] — the reference applies the
    # same threshold to its RAM-bounded partial aggregates and, for the two
    # click_to_* tables past 100M rows, to the raw per-chunk concat
    # (reference: model/count_co_events.py:131-133, 152-158; config.py:63).
    # Only runs with at least this many occupied rows are pruned, mirroring
    # the reference's "only when the table is big" trigger — small runs
    # (tests, small datasets) stay lossless. 0 disables.
    spill_prune_min_rows: int = 4_000_000

    # Raw pair-emission lanes per microbatch (uniform ladder run size).
    pair_budget: int = 1 << 22
    # Largest ladder run, in rows: bounds device memory held by pending runs
    # and sets the spill granularity (a top run covers
    # max_run_rows/pair_budget microbatches' pairs).
    max_run_rows: int = 1 << 26

    @property
    def names(self) -> List[str]:
        return list(self.count_types.keys())


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    """Candidate retrieval caps (reference: config.py:75-104 and
    model/retrieve.py:490-510)."""

    # Keep only the last N events per session by type (reference: config.py:76-79).
    n_last_clicks: int = 99
    n_last_carts: int = 99
    n_last_orders: int = 99
    n_most_frequent: int = 99

    # Recency-adaptive trim (reference: model/retrieve.py:493-496):
    # aid at recency order r keeps top max(3, 20 - 17/29*(r-1)) ranked pairs.
    trim_max_at_order_1: int = 20
    trim_min: int = 3
    trim_min_at_order: int = 20

    # Dense padded shapes for the device retrieval engine (no reference analogue:
    # the reference works on ragged DataFrames; we pad). Length bucketing
    # bounds the work: a bucket-8 session costs ~7x less than a bucket-64
    # one (fan-out grid is A_k * 121 entries, A_k <= L). p99 of unique aids
    # per test session is ~38 (reference: model/w2vec_aids.py:228-229).
    # Cap choice is measured (scripts/sweep_retrieval_caps.py; the round-1
    # record in git history, 30k heavy-tail synthetic sessions, mean_len 18
    # / max 512): ceiling recall@20-topall moves 0.61229 -> 0.61314 going
    # (32, 512) -> (99, 2048) while feature-stage lane volume scales
    # ~linearly in both caps. The reference keeps the last 99 events/type
    # (config.py:76-79) and sees up to 2322 candidates (README.md:42-47);
    # our dense union dedups aids first, so 32 kept aids ~= p97 of unique
    # test-session aids and 512 slots hold every observed candidate set
    # (sweep mean 223). Raise both for heavier-tailed data.
    max_session_aids: int = 32      # kept unique aids per session fed to sources
    max_candidates: int = 512       # padded candidate set per session
    session_len_buckets: Tuple[int, ...] = (8, 32, 128, 512)


@dataclasses.dataclass(frozen=True)
class Word2VecConfig:
    """Skip-gram/negative-sampling embedding model
    (reference: config.py:106-191 registry entries)."""

    name: str = "w2v-all"
    types: Tuple[int, ...] = (0, 1, 2)   # event types used as corpus filter
    vector_size: int = 100
    window: int = 10
    min_count: int = 5
    negatives: int = 8                    # SGNS negatives per positive
    batch_size: int = 65536
    # 5 = gensim's default sweep count, which the reference trains with
    # (reference: model/w2vec_aids.py:63 uses Word2Vec defaults). Round 3
    # shipped 3 to hide step cost; the round-4 block sampler makes the
    # full 5-epoch sweep cheaper than round 3's 3-epoch run was.
    epochs: int = 5
    learning_rate: float = 0.25   # Adagrad base lr (per-row adaptive)
    min_learning_rate: float = 0.05
    subsample_t: float = 1e-3             # frequent-word subsampling threshold
    ns_exponent: float = 0.75             # unigram^0.75 negative table
    seed: int = 42
    # 'device': on-device pair sampling (sessions upload once, preferred at
    # scale); 'host': numpy pair generation streamed per epoch.
    sampler: str = "device"
    # Negative sampling strategy: 'pair' draws `negatives` fresh per
    # positive (gensim parity, reference: model/w2vec_aids.py:63) but takes
    # DENSE autodiff grads — 3 full-table passes per step, so its step cost
    # grows with vocab size. 'chunk' shares a drawn pool within 64-pair
    # chunks — the negative tower then runs as matmuls with a tiny scatter,
    # a step cost flat in vocab size, at a measurable
    # embedding-quality cost on SMALL corpora (w2v-source retrieval recall
    # dropped ~2pts at 4k sessions; the cost vanishes with step count).
    # 'auto' (default) picks 'chunk' once the corpus/vocab is in the
    # production regime (>=100k vocab rows or >=5M corpus positions).
    neg_sharing: str = "auto"
    # Center-block sampling (round 4): each sampled center emits block_k
    # context pairs (gensim's sweep emits up to 2*window per position,
    # reference: model/w2vec_aids.py:63), so the center row gathers once
    # and its emb_in scatter shrinks to batch/block_k rows. 0/1 disables
    # (legacy per-pair sampling). Only affects chunk negative-sharing on a
    # single device; the model-parallel path keeps the per-pair sampler.
    block_k: int = 4
    # 'adagrad' (per-row adaptive, the deterministic-batch default) or
    # 'sgd' (gensim-parity plain SGD with linear alpha decay — skips the
    # 4 accumulator gathers/scatters per step; block sampler only).
    # MEASURED NEGATIVE: batched scatter-adds SUM the gradients of a row's
    # duplicate occurrences within a batch (a hot word appears 100s-1000s
    # of times per 64k batch), and without Adagrad's per-row rsqrt the
    # summed step diverges (NaN on the 200-vocab topics fixture at
    # alpha=0.05). gensim survives because its hogwild steps are
    # sequential — each tiny step re-saturates the sigmoid before the
    # next. Adagrad is what makes DETERMINISTIC batched SGNS stable; keep
    # the default unless batches are duplicate-free.
    optimizer: str = "adagrad"
    sgd_alpha: float = 0.025       # gensim Word2Vec(alpha=0.025) default
    sgd_min_alpha: float = 1e-4    # gensim min_alpha default

    # Max fori_loop steps fused into one device dispatch: the host regains
    # control between dispatches (epoch bookkeeping, checkpoints). Whether
    # whole-epoch dispatches are faster on the card is unmeasured
    # (ROADMAP D2).
    steps_per_dispatch: int = 64

    # kNN retrieval over the trained table (reference: config.py:109,124-125).
    knn_k: int = 20
    knn_first_n_aids: int = 600_000

    # Padded embedding row width; actual vectors use the first `vector_size`
    # dims, rest is zero. 128 was the tiling of the accelerator this was
    # first tuned for; its cost on a GPU is unmeasured (ROADMAP D7).
    padded_dim: int = 128


# The registry of w2vec variants (reference: config.py:110-191): the reference
# trains 4 models (2 aliases x {all types, carts+orders}); per split alias we
# train 2.
W2VEC_MODELS: Dict[str, Word2VecConfig] = {
    "w2v-all": Word2VecConfig(name="w2v-all", types=(0, 1, 2)),
    "w2v-1-2": Word2VecConfig(name="w2v-1-2", types=(1, 2)),
}


@dataclasses.dataclass(frozen=True)
class KMeansConfig:
    """Session clustering (reference: config.py:193-196,
    model/kmeans_sessions.py:142-161)."""

    n_clusters_to_find: Tuple[int, ...] = (50,)
    n_clusters_to_join: Tuple[int, ...] = (1, 50)
    max_iter: int = 100
    tol: float = 1e-3
    seed: int = 42
    # Session embedding weights (reference: model/kmeans_sessions.py:45-61).
    type_weights: Tuple[float, float, float] = (0.1, 0.3, 0.6)
    time_half_window: int = 3 * DAY
    min_time_weight: float = 0.10


@dataclasses.dataclass(frozen=True)
class PopularityConfig:
    """Cluster-popularity counting (reference: model/count_popularity.py)."""

    keep_top_k: int = KEEP_TOP_K
    recent_window: int = 7 * DAY
    rank_clip: int = 999


@dataclasses.dataclass(frozen=True)
class RankerConfig:
    """LambdaRank scoring tower (replaces LightGBM lambdarank,
    reference: config.py:207-227). The MLP tower is the one intentional model
    class change (see SURVEY.md §7 'Hard parts')."""

    hidden_dims: Tuple[int, ...] = (256, 128, 64)
    # defaults = best of a 20k-session synthetic sweep on the CPU: lr 1e-3 / no dropout / warmup+cosine / early stop
    # reached 85.0% of the retrieval ceiling vs 82.9% for the round-2
    # fixed-lr 3-epoch loop. GBDT (91.1%) remains the default backend.
    dropout: float = 0.0
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    epochs: int = 16
    batch_sessions: int = 256            # sessions per step
    max_group: int = 128                 # padded candidates per session group
    eval_at: int = 20                    # ndcg@20 (reference: config.py:224)
    seed: int = 42
    sigma: float = 1.0                   # lambdarank pairwise logistic scale
    # linear-warmup + cosine-decay lr schedule (fraction of total steps
    # spent warming up; end lr = end_lr_frac * learning_rate)
    warmup_frac: float = 0.05
    end_lr_frac: float = 0.05
    # stop when valid ndcg@eval_at hasn't improved for this many epochs;
    # the best-epoch params are restored (the reference ships LightGBM
    # early_stopping commented out but tracks best-iter, utils.py:77-93).
    # 0 disables (runs all epochs; best-epoch params still kept).
    early_stop_epochs: int = 4
    # listwise group context: augment each candidate's input with
    # group-relative deltas (x - mean_g, x - max_g over the session's valid
    # candidates) — the MLP analogue of LightGBM's session-grouped splits
    # (models/ranker.py score()). Measured NEUTRAL-to-slightly-negative on
    # the 20k synthetic sweep (83.9% vs 84.8% of ceiling at the same lr),
    # so off by default; kept as a capability for real-data tuning.
    group_context: bool = False

    # Negative downsampling (reference: config.py:203-204).
    neg_to_pos_ratio: int = 40
    max_neg_per_session: int = 100
    # Compute the downsample KEEP masks on device, fused into the pass-A
    # packed-meta dispatch (engine/retrieval.py::_label_keep_bits_program):
    # the host selection's three [S, C] argsorts cost ~0.5 s/batch on the
    # 2-core box at [2048, 512]. Selection semantics are identical (all
    # positives + min(ratio*n_pos, cap) uniformly-drawn negatives per
    # session with a positive) but the random draws come from the device
    # PRNG, so rows differ from the host path draw-for-draw; default off
    # to preserve the streaming==batch bit-equivalence contract, enabled
    # by reference-scale runs (scripts/run_fullscale.py).
    device_select: bool = False


@dataclasses.dataclass(frozen=True)
class GBDTConfig:
    """Histogram-GBDT lambdarank (models/gbdt.py) hyperparameters mirroring
    the reference's PARAMS_LGBM semantics (reference: config.py:207-221):
    150 trees, depth 4, lr 0.25, colsample 0.25, subsample 0.5,
    min_child_samples 20, ndcg@20."""

    n_trees: int = 150
    max_depth: int = 4
    n_bins: int = 64
    learning_rate: float = 0.25
    colsample: float = 0.25          # feature fraction per tree
    subsample: float = 0.5           # row (bagging) fraction per tree
    min_child_samples: int = 20
    min_child_hessian: float = 1e-3
    lambda_l2: float = 0.0
    sigma: float = 1.0               # lambdarank logistic scale
    ndcg_at: int = 20                # truncation for |dNDCG| pair weights
    lambda_norm: bool = True         # LightGBM per-query lambda normalization
    max_group: int = 128             # padded candidates per session group
    seed: int = 42
    # Periodic valid ndcg@20 every N trees (the reference logs eval every 25
    # iterations, reference: config.py:223-227 'verbose': 25) + best-iter
    # tracking (reference: utils.py:77-93). 0 disables periodic eval (one
    # final eval only).
    eval_every: int = 25
    # Stop when valid ndcg hasn't improved for N trees; the best-iter model
    # is kept. 0 = off (the reference ships early_stopping commented out,
    # reference: config.py:225).
    early_stopping_rounds: int = 0
    # Cap on training session groups fed to the device (seeded subsample
    # when exceeded; 0 = no cap). Grouped-padded bins are
    # groups * max_group * F bytes of HBM — reference-scale clicks
    # (~1.5M positive sessions) would need ~20 GB; 2^18 groups (~12M real
    # rows, the reference's carts-train magnitude) costs ~3.5 GB. LightGBM
    # itself bags rows per tree at subsample=0.5 (reference: config.py:218).
    max_train_groups: int = 1 << 18
    # Valid groups kept for periodic ndcg (same padding cost argument).
    max_valid_groups: int = 1 << 16

    # device-shape knobs (tune for HBM, not quality)
    row_chunk: int = 1 << 14         # rows per histogram matmul chunk
    group_chunk: int = 1 << 10       # groups per pairwise-lambda chunk
    # Max trees fused into one boosting dispatch; the periodic valid eval
    # lands on dispatch boundaries. Whether one whole-run dispatch is
    # faster on the card is unmeasured (ROADMAP D2).
    trees_per_dispatch: int = 50


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset / split parameters (reference: etl/split_to_train_test.sh,
    etl/jsonl_to_parquet.py)."""

    test_days: int = 7                    # carve-out window for the local split
    chunk_sessions: int = 100_000         # ingestion chunk (reference: etl/jsonl_to_parquet.py:59)
    seed: int = 42


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout. Axes: 'data' (session/batch sharding)
    and 'model' (row-sharded embedding tables / count shards)."""

    data_axis: str = "data"
    model_axis: str = "model"
    # -1 = all devices on the data axis (pure DP) unless overridden.
    data_parallel: int = -1
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    """Root configuration object."""

    work_dir: str = "artifacts"
    covis: CoVisConfig = dataclasses.field(default_factory=CoVisConfig)
    retrieval: RetrievalConfig = dataclasses.field(default_factory=RetrievalConfig)
    w2vec: Dict[str, Word2VecConfig] = dataclasses.field(
        default_factory=lambda: dict(W2VEC_MODELS)
    )
    kmeans: KMeansConfig = dataclasses.field(default_factory=KMeansConfig)
    popularity: PopularityConfig = dataclasses.field(default_factory=PopularityConfig)
    ranker: RankerConfig = dataclasses.field(default_factory=RankerConfig)
    gbdt: GBDTConfig = dataclasses.field(default_factory=GBDTConfig)
    # which C16 model class scores candidates: "gbdt" (LightGBM-parity
    # histogram trees) or "mlp" (LambdaRank tower)
    ranker_backend: str = "gbdt"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT = Config()


# ---------------------------------------------------------------------------
# Config persistence: the work dir is the artifact contract between stages
# (reference keeps one config.py fixed across its 15 scripts); persisting the
# config there lets inference-only runs (rank/submit) reload exactly the
# configuration the artifacts were built with.
# ---------------------------------------------------------------------------
def _coerce_tuples(obj):
    """JSON round-trip turns tuples into lists; every sequence field in the
    config dataclasses is a Tuple, so coerce all lists back recursively."""
    if isinstance(obj, list):
        return tuple(_coerce_tuples(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _coerce_tuples(v) for k, v in obj.items()}
    return obj


def config_to_json(cfg: Config, path: str) -> None:
    import json

    with open(path, "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh, indent=2)


def config_from_json(path: str) -> Config:
    import json

    with open(path) as fh:
        d = _coerce_tuples(json.load(fh))
    return Config(
        work_dir=d.get("work_dir", "artifacts"),
        covis=CoVisConfig(**d["covis"]),
        retrieval=RetrievalConfig(**d["retrieval"]),
        w2vec={k: Word2VecConfig(**v) for k, v in d["w2vec"].items()},
        kmeans=KMeansConfig(**d["kmeans"]),
        popularity=PopularityConfig(**d["popularity"]),
        ranker=RankerConfig(**d["ranker"]),
        gbdt=GBDTConfig(**d["gbdt"]),
        ranker_backend=d.get("ranker_backend", "gbdt"),
        data=DataConfig(**d["data"]),
        mesh=MeshConfig(**d["mesh"]),
    )


# ---------------------------------------------------------------------------
# Process bootstrap (reference: config.py:18-27) — opt-in, not at import.
# ---------------------------------------------------------------------------
def compilation_cache_dir() -> str:
    """Where compiled programs persist: JAX_COMPILATION_CACHE_DIR when set,
    else `.jax_cache` at the root of the checkout. The path is fixed
    because the cache directory is part of the cache key."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        Path(__file__).resolve().parents[1] / ".jax_cache"
    )


def enable_persistent_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at `compilation_cache_dir()`
    and return that path. The one place in the program that sets the
    cache; the CLI, the pipeline and the scripts call it so that every
    process shares compiled programs. Safe to call repeatedly."""
    import jax

    path = compilation_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def setup_logging(work_dir: str | None = None, level: int = logging.INFO) -> None:
    handlers: List[logging.Handler] = [logging.StreamHandler()]
    if work_dir is not None:
        Path(work_dir).mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(work_dir, "logs.log")))
    logging.basicConfig(
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        handlers=handlers,
        level=level,
        force=True,
    )
