"""Pipeline-level mesh-size invariance: Pipeline(mesh=4x1) on the virtual
CPU mesh must produce the SAME retrieval ceiling and essentially the same
end metrics as the single-device pipeline — the sharded covis counter
(all-to-all count exchange), dp KMeans, dp GBDT and data-sharded retrieval
all wired through the production runner."""
import dataclasses

import jax
import numpy as np
import pytest

from otto_tpu.config import (
    Config,
    CoVisConfig,
    GBDTConfig,
    KMeansConfig,
    RankerConfig,
    RetrievalConfig,
    Word2VecConfig,
)
from otto_tpu.data.split import split_events
from otto_tpu.data.synthetic import SyntheticSpec, generate
from otto_tpu.parallel.mesh import make_mesh
from otto_tpu.pipeline.runner import Pipeline


def _cfg():
    w2v = dict(
        wall=Word2VecConfig(name="wall", types=(0, 1, 2), vector_size=16,
                            window=4, min_count=2, epochs=2, batch_size=4096,
                            knn_k=10, knn_first_n_aids=800),
    )
    return Config(
        covis=dataclasses.replace(CoVisConfig(), accumulator_capacity=1 << 17),
        retrieval=RetrievalConfig(
            max_session_aids=16, max_candidates=128,
            session_len_buckets=(8, 32),
        ),
        w2vec={**w2v, "w12": dataclasses.replace(
            w2v["wall"], name="w12", types=(1, 2), epochs=1)},
        kmeans=dataclasses.replace(KMeansConfig(), max_iter=10),
        ranker=RankerConfig(hidden_dims=(32, 16), epochs=2, batch_sessions=64,
                            max_group=64),
        gbdt=GBDTConfig(n_trees=10, max_depth=3, n_bins=16, colsample=0.5,
                        subsample=0.8, min_child_samples=5, max_group=64,
                        row_chunk=4096, group_chunk=64),
    )


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs >= 4 devices")
def test_pipeline_mesh_invariance(tmp_path):
    spec = SyntheticSpec(n_sessions=1200, n_aids=600, mean_len=10,
                         span_days=21, seed=17)
    ev = generate(spec)
    sp = split_events(ev, 7, 42)
    cfg = _cfg()

    pipe_1 = Pipeline(cfg=cfg, work_dir=str(tmp_path / "one"),
                      n_aids=spec.n_aids)
    m_1 = pipe_1.run(sp.train, sp.test, sp.labels, batch_sessions=64)

    ctx = make_mesh(jax.devices()[:4], data_parallel=4, model_parallel=1)
    pipe_n = Pipeline(cfg=cfg, work_dir=str(tmp_path / "four"),
                      n_aids=spec.n_aids, mesh=ctx)
    m_n = pipe_n.run(sp.train, sp.test, sp.labels, batch_sessions=64)

    # co-vis counting and retrieval are exact -> ceiling metrics identical
    for k in ("ceiling_clicks", "ceiling_carts", "ceiling_orders",
              "ceiling_total"):
        assert abs(m_n[k] - m_1[k]) < 1e-12, (k, m_n[k], m_1[k])
    # ranked metrics: dp GBDT bagging rng differs per shard by design
    # (reference DaskLGBMRanker is likewise not bit-equal to single-process
    # LightGBM); quality must stay in-family
    for k in ("clicks", "carts", "orders", "total"):
        assert abs(m_n[k] - m_1[k]) < 0.12, (k, m_n[k], m_1[k])
    assert m_n["total"] > 0.2


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs >= 4 devices")
def test_sharded_covis_counter_matches_single(tmp_path):
    """ShardedCoVisCounter.finalize must equal CoVisCounter.finalize exactly
    (the pipeline-facing contract behind the invariance above)."""
    from otto_tpu.engine.covis import CoVisCounter, ShardedCoVisCounter

    ev = generate(SyntheticSpec(n_sessions=400, n_aids=300, mean_len=8,
                                seed=23))
    cfg = CoVisConfig()
    ctx = make_mesh(jax.devices()[:4], data_parallel=4, model_parallel=1)

    single = CoVisCounter(cfg, capacity=1 << 15, bucket_lens=(8, 32),
                          spill=True)
    single.update(ev)
    sharded = ShardedCoVisCounter(cfg, ctx, capacity_per_shard=1 << 13,
                                  bucket_lens=(8, 32))
    sharded.update(ev)

    f1, fn = single.finalize(), sharded.finalize()
    for name in cfg.names:
        a, b = f1[name], fn[name]
        np.testing.assert_array_equal(np.asarray(a.aid), np.asarray(b.aid))
        np.testing.assert_array_equal(
            np.asarray(a.aid_next), np.asarray(b.aid_next))
        np.testing.assert_array_equal(
            np.asarray(a.count), np.asarray(b.count))
