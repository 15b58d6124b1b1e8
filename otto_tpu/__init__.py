"""otto_tpu — a session-recommender engine on JAX/XLA accelerators.

A from-scratch JAX/XLA re-design of the OTTO multi-objective recommender
pipeline (reference: nicolaivicol/otto-recommender). The reference is a 15-step
CPU batch pipeline (polars/gensim/faiss/LightGBM); here every hot loop is a
sharded device computation:

* co-visitation counting  -> masked pair-emission + sort/segment-sum compress
                             (reference: model/count_co_events.py)
* word2vec item embeddings-> JAX skip-gram negative sampling, row-sharded table
                             (reference: model/w2vec_aids.py gensim hogwild)
* kNN retrieval           -> exact tiled MIPS/L2 top-k (matmul + running top_k)
                             (reference: faiss IndexIVFFlat, model/w2vec_aids.py:98-110)
* KMeans session clusters -> Lloyd's iterations as matmul+argmin+segment-sum
                             (reference: dask_ml / sklearn, model/kmeans_sessions.py)
* candidate retrieval     -> fused multi-source gather + dense segmented reductions
                             (reference: model/retrieve.py)
* ranking                 -> histogram-GBDT lambdarank on device
                             (reference: LightGBM lambdarank, model/train_lgbm_rankers.py)

Layering (mirrors SURVEY.md §1):
  L0 config/infra:   otto_tpu.config, otto_tpu.parallel, otto_tpu.utils
  L1 data:           otto_tpu.data  (ingestion, split, batching, synthetic)
  L2 stats builders: otto_tpu.engine.covis / popularity / session_embed, otto_tpu.models.word2vec / kmeans
  L3 retrieval:      otto_tpu.engine.retrieval
  L4 ranking/eval:   otto_tpu.models.ranker, otto_tpu.engine.{downsample,rank,submit}, otto_tpu.eval
"""

__version__ = "0.1.0"
