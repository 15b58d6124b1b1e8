"""Full pipeline integration: synth -> split -> count -> embed -> cluster ->
retrieve -> downsample -> train rankers -> rank -> submit -> eval. The
learned ranker pipeline must beat the popularity baseline and produce a
valid Kaggle-format submission."""
import dataclasses
import json
import os

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
from otto_tpu.data.synthetic import SyntheticSpec
from otto_tpu.pipeline.runner import run_synthetic
from otto_tpu.engine.rank import read_submission


@pytest.fixture(scope="module")
def tiny_cfg():
    w2v = dict(
        wall=Word2VecConfig(name="wall", types=(0, 1, 2), vector_size=16,
                            window=4, min_count=2, epochs=2, batch_size=4096,
                            knn_k=10, knn_first_n_aids=800),
        w12=Word2VecConfig(name="w12", types=(1, 2), vector_size=16,
                           window=4, min_count=2, epochs=1, batch_size=4096,
                           knn_k=10, knn_first_n_aids=800),
    )
    return Config(
        covis=dataclasses.replace(CoVisConfig(), accumulator_capacity=1 << 17),
        retrieval=RetrievalConfig(
            max_session_aids=16, max_candidates=128,
            session_len_buckets=(8, 32),
        ),
        w2vec=w2v,
        kmeans=dataclasses.replace(KMeansConfig(), max_iter=10),
        ranker=RankerConfig(hidden_dims=(32, 16), epochs=3, batch_sessions=64,
                            max_group=64, learning_rate=3e-3),
        gbdt=GBDTConfig(n_trees=20, max_depth=3, n_bins=16, colsample=0.5,
                        subsample=0.8, min_child_samples=5, max_group=64,
                        row_chunk=4096, group_chunk=256),
    )


@pytest.fixture(scope="module")
def pipeline_metrics(tiny_cfg, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("pipe"))
    spec = SyntheticSpec(n_sessions=2500, n_aids=1200, mean_len=10,
                         span_days=21, seed=11)
    metrics = run_synthetic(tiny_cfg, work, spec, batch_sessions=64)
    return work, metrics


def test_pipeline_produces_all_artifacts(pipeline_metrics):
    work, _ = pipeline_metrics
    for f in (
        "covis.pkl", "w2v-wall.npz", "w2v-w12.npz", "knn-wall.npz",
        "session_emb.npz", "clusters.npz", "ranker-gbdt-clicks.npz",
        "ranker-gbdt-carts.npz", "ranker-gbdt-orders.npz", "submission.csv",
        "eval_retrieved.json", "eval_submission.json",
        "feat-importance-clicks.csv", "kmeans-inertia.csv",
    ):
        assert os.path.exists(os.path.join(work, f)), f


# Golden-metric regression pins: recorded from a
# seeded CPU run of exactly the fixture's spec+config (2026-08-20). The
# pipeline is deterministic per platform; the tolerance absorbs cross-
# platform reduction-order drift (CPU vs virtual-mesh CI vs GPU), NOT
# algorithm changes — a real recall regression trips these long before it
# trips the loose sanity bounds below.
GOLDEN = {
    "ceiling_clicks": 0.62484, "ceiling_carts": 0.48361,
    "ceiling_orders": 0.69253, "ceiling_total": 0.62308,
    "clicks": 0.46607, "carts": 0.37090, "orders": 0.63218,
    "total": 0.53719,
}


def test_pipeline_golden_metrics(pipeline_metrics):
    _, m = pipeline_metrics
    for k, want in GOLDEN.items():
        tol = 0.005 if k.startswith("ceiling") else 0.03
        assert abs(m[k] - want) < tol, (k, m[k], want)


def test_pipeline_metrics_sane(pipeline_metrics):
    _, m = pipeline_metrics
    # retrieval ceiling must exceed the ranked top-20 recall
    assert m["ceiling_total"] >= m["total"] - 1e-9
    # learned pipeline beats chance comfortably on orders (revisit signal)
    assert m["orders"] > 0.3
    assert m["total"] > 0.2
    assert 0 <= m["clicks"] <= 1 and 0 <= m["carts"] <= 1


def test_submission_format(pipeline_metrics):
    work, _ = pipeline_metrics
    sub = read_submission(os.path.join(work, "submission.csv"))
    assert set(sub) == {"clicks", "carts", "orders"}
    some = next(iter(sub["clicks"].values()))
    assert len(some) <= 20
    assert all(isinstance(a, int) for a in some)
    # all three types predict the same session set
    assert set(sub["clicks"]) == set(sub["orders"])


def test_streaming_runner_matches_batch(tiny_cfg, pipeline_metrics, tmp_path):
    """run_streaming (two-pass, O(one batch) device feature memory) must
    reproduce run()'s metrics exactly: identical downsample selection (the
    per-type rng streams replay the all-at-once draws), identical ranker
    training rows, identical scoring."""
    _, batch_metrics = pipeline_metrics
    from otto_tpu.data.split import split_events
    from otto_tpu.data.synthetic import generate
    from otto_tpu.pipeline.runner import Pipeline

    spec = SyntheticSpec(n_sessions=2500, n_aids=1200, mean_len=10,
                         span_days=21, seed=11)
    ev = generate(spec)
    sp = split_events(ev, tiny_cfg.data.test_days, tiny_cfg.data.seed)
    pipe = Pipeline(cfg=tiny_cfg, work_dir=str(tmp_path), n_aids=spec.n_aids)
    m = pipe.run_streaming(sp.train, sp.test, sp.labels, batch_sessions=64)
    for k in ("ceiling_total", "clicks", "carts", "orders", "total"):
        assert abs(m[k] - batch_metrics[k]) < 1e-9, (k, m[k], batch_metrics[k])

    # the per-source recall report (streaming: accumulated ON DEVICE from
    # the packed meta + label bits) must match the batch runner's host
    # report to fp tolerance (the device path sums integer hit counters,
    # so weighted totals can differ in the last ulp)
    work_batch, _ = pipeline_metrics
    a = json.load(open(os.path.join(work_batch, "eval_retrieved_sources.json")))
    b = json.load(open(os.path.join(str(tmp_path), "eval_retrieved_sources.json")))

    def close(x, y, path=""):
        assert type(x) is type(y) or (
            isinstance(x, (int, float)) and isinstance(y, (int, float))
        ), (path, x, y)
        if isinstance(x, dict):
            assert set(x) == set(y), (path, set(x) ^ set(y))
            for k in x:
                close(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, (int, float)):
            assert abs(x - y) < 1e-9, (path, x, y)
        else:
            assert x == y, (path, x, y)

    close(a, b)


def test_inference_only_flow(tiny_cfg, pipeline_metrics):
    """Train-on-split -> predict-on-unlabeled (the reference's production
    path, model/rank.py:17-61 + submit.py:14-61): running the pipeline with
    labels=None in a work dir holding trained rankers must score the test
    set and write submission.csv — for BOTH the batch and streaming runners,
    with identical top-20s (same rankers, same retrieval)."""
    work, _ = pipeline_metrics  # holds trained ranker artifacts
    from otto_tpu.data.split import split_events
    from otto_tpu.data.synthetic import generate
    from otto_tpu.pipeline.runner import Pipeline

    spec = SyntheticSpec(n_sessions=2500, n_aids=1200, mean_len=10,
                         span_days=21, seed=11)
    ev = generate(spec)
    sp = split_events(ev, tiny_cfg.data.test_days, tiny_cfg.data.seed)
    pipe = Pipeline(cfg=tiny_cfg, work_dir=work, n_aids=spec.n_aids)

    sub_path = os.path.join(work, "submission.csv")
    os.remove(sub_path)
    m = pipe.run(sp.train, sp.test, None, batch_sessions=64)
    assert m == {}
    assert os.path.exists(sub_path)
    sub_batch = read_submission(sub_path)
    assert set(sub_batch) == {"clicks", "carts", "orders"}
    assert set(sub_batch["clicks"]) == set(np.unique(sp.test.session).tolist())

    os.remove(sub_path)
    m = pipe.run_streaming(sp.train, sp.test, None, batch_sessions=64)
    assert m == {}
    sub_stream = read_submission(sub_path)
    assert sub_stream == sub_batch


def test_load_rankers_missing_raises(tiny_cfg, tmp_path):
    from otto_tpu.pipeline.runner import Pipeline

    pipe = Pipeline(cfg=tiny_cfg, work_dir=str(tmp_path), n_aids=10)
    with pytest.raises(FileNotFoundError, match="no trained gbdt ranker"):
        pipe.load_rankers()


def test_pipeline_resume_from_cache(tiny_cfg, pipeline_metrics):
    """Re-running with the same work dir must reuse artifacts (reference
    resumability semantics, SURVEY.md §5.3-4)."""
    work, first = pipeline_metrics
    import time
    from otto_tpu.data.split import split_events
    from otto_tpu.data.synthetic import SyntheticSpec, generate
    from otto_tpu.pipeline.runner import Pipeline

    spec = SyntheticSpec(n_sessions=2500, n_aids=1200, mean_len=10,
                         span_days=21, seed=11)
    ev = generate(spec)
    sp = split_events(ev, 7, 42)
    t = time.time()
    pipe = Pipeline(cfg=tiny_cfg, work_dir=work, n_aids=spec.n_aids)
    second = pipe.run(sp.train, sp.test, sp.labels, batch_sessions=64)
    # cached heavy stages (covis/w2v/rankers) make the rerun much faster;
    # metrics identical because every model artifact is reloaded
    for k in ("clicks", "carts", "orders", "total"):
        assert abs(second[k] - first[k]) < 1e-9


def test_stale_cache_guard(tiny_cfg, pipeline_metrics):
    """A work dir holding artifacts for a different config or n_aids must
    be rejected at Pipeline construction (a stale vocab/covis cache would
    otherwise produce silently-wrong or crashing stages)."""
    import dataclasses
    from otto_tpu.pipeline.runner import Pipeline

    work, _ = pipeline_metrics
    with pytest.raises(ValueError, match="n_aids"):
        Pipeline(cfg=tiny_cfg, work_dir=work, n_aids=999)
    other = dataclasses.replace(
        tiny_cfg, kmeans=dataclasses.replace(tiny_cfg.kmeans, max_iter=7)
    )
    with pytest.raises(ValueError, match="kmeans"):
        Pipeline(cfg=other, work_dir=work, n_aids=1200)
    # use_cache=False overwrites instead of rejecting
    Pipeline(cfg=other, work_dir=work, n_aids=1200, use_cache=False)


def test_streaming_device_select(tiny_cfg, pipeline_metrics, tmp_path):
    """RankerConfig.device_select (the reference-scale pass-A path: keep
    bits computed on device, host reduced to np.nonzero) must run the
    streaming pipeline end to end with the retrieval ceiling IDENTICAL to
    the host path (selection only changes ranker training rows) and the
    ranked metrics in the same quality regime — the random draws come from
    the device PRNG, so row-level equality with the host path is not
    expected."""
    _, batch_metrics = pipeline_metrics
    from otto_tpu.data.split import split_events
    from otto_tpu.data.synthetic import generate
    from otto_tpu.pipeline.runner import Pipeline

    cfg = dataclasses.replace(
        tiny_cfg,
        ranker=dataclasses.replace(tiny_cfg.ranker, device_select=True),
    )
    spec = SyntheticSpec(n_sessions=2500, n_aids=1200, mean_len=10,
                         span_days=21, seed=11)
    ev = generate(spec)
    sp = split_events(ev, cfg.data.test_days, cfg.data.seed)
    pipe = Pipeline(cfg=cfg, work_dir=str(tmp_path), n_aids=spec.n_aids)
    m = pipe.run_streaming(sp.train, sp.test, sp.labels, batch_sessions=64)
    assert abs(m["ceiling_total"] - batch_metrics["ceiling_total"]) < 1e-9
    # same quality regime as the host-selection run (rows differ by draw)
    assert m["total"] > 0.5 * batch_metrics["total"]
    # the C15 artifacts exist and carry both classes
    for t in ("clicks", "carts", "orders"):
        z = np.load(os.path.join(str(tmp_path), f"downsampled-{t}.npz"))
        assert len(z["y"]) > 0 and 0 < z["y"].sum() < len(z["y"])
