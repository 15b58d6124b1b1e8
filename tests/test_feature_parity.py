"""Feature-catalog parity audit vs the reference ranker-input contract.

The reference ranker consumes every retrieved-parquet column except keys and
targets (reference: model/train_lgbm_rankers.py:38-40 _infer_feats_from_df,
non_feats = [session, aid_next, target_*, rank_total_cl1]). This test
enumerates that column set from model/retrieve.py line by line — EXCLUDING
the intermediate columns the reference drops before saving (max_ts_aid* and
mean_max_ts_aid* at retrieve.py:543-546, slf_max_ts* ibid., min/max_ts_session
ibid., aid_next_is_aid at :571, cl50 at :585, best_* trim temporaries at
:516-517) — and pins FEATURE_NAMES to it.

Verdict: the ranker-visible reference catalog is exactly 103 columns; the
otto_tpu catalog implements all 103 plus ONE documented extension
(heur_score, the heuristic baseline's score as a ranker input —
engine/retrieval.py FEATURE_NAMES tail comment).
"""
from otto_tpu.engine.retrieval import COVIS_NAMES, FEATURE_NAMES

REFERENCE_RANKER_FEATURES = (
    # --- session stats (reference: model/retrieve.py:115-135, joined :522) ---
    "n_events_session", "n_aids_session", "n_clicks_session",
    "n_carts_session", "n_orders_session", "duration_session",
    "only_orders_session",
    # --- self features (reference :309-334; slf_max_ts* -> slf_since_ts*
    #     at :533-537, raw max_ts dropped :543-546) ---
    "slf_n", "slf_n_clicks", "slf_n_carts", "slf_n_orders",
    "slf_rank_by_n", "slf_rank_by_n_carts", "slf_rank_by_n_orders",
    "slf_since_ts", "slf_since_ts_clicks", "slf_since_ts_carts",
    "slf_since_ts_orders", "slf_ts_rel_pos_in_session", "slf_ts_order",
    "slf_ts_order_rel", "slf_ts_order_clicks", "slf_ts_order_carts",
    "slf_ts_order_orders", "slf_left_in_cart",
    # --- aggregated session-aid features (reference :337-364) ---
    "n_uniq_aid", "n_uniq_aid_clicks", "n_uniq_aid_carts",
    "n_uniq_aid_orders", "n_aid", "n_aid_clicks", "n_aid_carts",
    "n_aid_orders", "ts_order_aid", "ts_order_aid_rel",
    "ts_order_aid_clicks", "ts_order_aid_carts", "ts_order_aid_orders",
    "ts_aid_rel_pos_in_session", "rank_by_n_aid",
    # --- derived time features (reference :526-555; max_ts_aid*/mean_max_*
    #     sources dropped after derivation :543-546) ---
    "since_ts_aid", "since_ts_aid_clicks", "since_ts_aid_carts",
    "since_ts_aid_orders", "since_session_start_ts_aid",
    "since_session_start_ts_aid_orders", "rel_pos_max_ts_aid_in_session",
    "rel_pos_mean_max_ts_aid_in_session",
    "rel_pos_mean_max_ts_aid_orders_in_session",
    # --- co-visitation features x5 (reference :367-376, derivation :18-63) ---
    *(f"{t}_{f}" for t in COVIS_NAMES
      for f in ("count", "count_pop", "perc_pop", "rank", "count_rel")),
    # --- w2vec aggregates (reference :379-389) ---
    *(f"{f}_{s}" for s in ("all", "1_2")
      for f in ("n_w2vec", "dist_w2vec", "rank_w2vec", "best_rank_w2vec")),
    # --- source flags (reference :558-569 + src_pop_cl50 :580) ---
    "src_any", "src_self",
    *(f"src_{t}" for t in COVIS_NAMES),
    "src_w2vec_all", "src_w2vec_1_2", "src_pop_cl50",
    # --- cluster-popularity ranks (reference :572-590;
    #     count_popularity.py:73-79 column list) ---
    *(f"rank_{x}_cl50" for x in
      ("clicks", "carts", "orders", "clicks_7d", "carts_7d", "orders_7d")),
    "rank_clicks_cl1", "rank_carts_cl1", "rank_orders_cl1",
    # --- embedding similarity (reference :604-625) ---
    "cos_sim_ses_aid", "eucl_dist_ses_aid",
)

# the one intentional addition beyond the reference catalogue
OTTO_EXTENSIONS = ("heur_score",)


def test_reference_catalog_size():
    assert len(set(REFERENCE_RANKER_FEATURES)) == len(REFERENCE_RANKER_FEATURES)
    assert len(REFERENCE_RANKER_FEATURES) == 103


def test_all_reference_features_implemented():
    missing = set(REFERENCE_RANKER_FEATURES) - set(FEATURE_NAMES)
    assert not missing, f"reference features missing from FEATURE_NAMES: {sorted(missing)}"


def test_no_undocumented_extensions():
    extra = set(FEATURE_NAMES) - set(REFERENCE_RANKER_FEATURES)
    assert extra == set(OTTO_EXTENSIONS), (
        f"undocumented feature extensions: {sorted(extra - set(OTTO_EXTENSIONS))}"
    )
    assert len(FEATURE_NAMES) == 103 + len(OTTO_EXTENSIONS)
