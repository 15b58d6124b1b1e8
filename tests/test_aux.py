"""Aux subsystems: checkpoint/resume, reports, per-source eval."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from otto_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from otto_tpu.utils.reports import describe_numeric, report_name
from otto_tpu.utils.timing import StageTimer, time_fn


def test_checkpoint_roundtrip(tmp_path):
    state = {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.zeros(3)}
    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(p, state, step=7)
    restored, step = load_checkpoint(p, state)
    assert step == 7
    np.testing.assert_array_equal(np.asarray(restored["w"]), np.asarray(state["w"]))


def test_checkpoint_missing_returns_none(tmp_path):
    assert load_checkpoint(str(tmp_path / "nope.npz"), {"x": jnp.zeros(1)}) is None


def test_w2v_device_resume(tmp_path, monkeypatch):
    from otto_tpu.config import Word2VecConfig
    from otto_tpu.models.word2vec import train_word2vec_device
    from tests.test_word2vec import simple_events

    # saves are opt-in (each pulls the full tables to the host);
    # every-epoch here exercises save + mid-training resume
    monkeypatch.setenv("OTTO_W2V_CKPT_EVERY", "1")
    ev = simple_events(n_sessions=100, sess_len=6)
    ck = str(tmp_path / "w2v_ck.npz")
    cfg = Word2VecConfig(name="t", vector_size=8, min_count=1, epochs=2,
                         batch_size=1024, window=3, subsample_t=0)
    m1 = train_word2vec_device(ev, cfg, n_aids=20, checkpoint_path=ck)
    # the final epoch never saves (the model .npz artifact supersedes it),
    # so the file holds the epoch-1 state
    assert os.path.exists(ck)
    # resume: restart at epoch 1, recompute epoch 2 -> identical embeddings
    # (epoch sampling is keyed by epoch index, so the recompute is
    # bit-deterministic from the checkpointed state)
    m2 = train_word2vec_device(ev, cfg, n_aids=20, checkpoint_path=ck)
    np.testing.assert_array_equal(m1.emb, m2.emb)


def test_checkpoint_shape_mismatch_discarded(tmp_path):
    """A checkpoint whose leaf shapes differ from the caller's template is
    discarded, not restored — shapes come from the file, so a stale vocab
    would otherwise load 'successfully' and corrupt training."""
    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(p, {"w": jnp.zeros((4, 3))}, step=1)
    assert load_checkpoint(p, {"w": jnp.zeros((5, 3))}) is None
    assert load_checkpoint(p, {"w": jnp.zeros((4, 3))}) is not None
    # leaf-count mismatch likewise
    assert (
        load_checkpoint(p, {"w": jnp.zeros((4, 3)), "b": jnp.zeros(3)}) is None
    )


def test_checkpoint_meta_mismatch_discarded(tmp_path):
    p = str(tmp_path / "ckpt.npz")
    meta = {"V": 100, "vector_size": 8, "seed": 42}
    save_checkpoint(p, {"w": jnp.zeros(2)}, step=3, meta=meta)
    ok = load_checkpoint(p, {"w": jnp.zeros(2)}, expect_meta=meta)
    assert ok is not None and ok[1] == 3
    stale = dict(meta, V=200)
    assert load_checkpoint(p, {"w": jnp.zeros(2)}, expect_meta=stale) is None
    # a checkpoint written WITHOUT meta fails a caller that expects one
    save_checkpoint(p, {"w": jnp.zeros(2)}, step=3)
    assert load_checkpoint(p, {"w": jnp.zeros(2)}, expect_meta=meta) is None


def test_w2v_device_resume_mp(tmp_path, monkeypatch):
    """Model-parallel mid-training resume: the checkpoint stores
    device-independent [V, ...] state (NOT the Vp-padded shards), so a
    resumed MP run re-pads/re-shards correctly and reproduces the
    uninterrupted MP run bit-for-bit (a padded save would re-pad on
    restore into [2*Vp-V, D] tables)."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 devices")
    from otto_tpu.config import Word2VecConfig
    from otto_tpu.models.word2vec import train_word2vec_device
    from otto_tpu.parallel.mesh import make_mesh
    from tests.test_word2vec import simple_events

    mesh = make_mesh(jax.devices()[:4], data_parallel=1, model_parallel=4)
    monkeypatch.setenv("OTTO_W2V_CKPT_EVERY", "1")
    ev = simple_events(n_sessions=100, sess_len=6)
    ck = str(tmp_path / "w2v_ck_mp.npz")
    # V=18-ish is NOT divisible by 4 shards -> exercises the Vp padding
    cfg = Word2VecConfig(name="tmp", vector_size=8, min_count=1, epochs=2,
                         batch_size=1024, window=3, subsample_t=0)
    m1 = train_word2vec_device(ev, cfg, n_aids=20, checkpoint_path=ck,
                               mesh_ctx=mesh)
    assert os.path.exists(ck)  # holds the epoch-1 state
    # saved state must be the TRUE-V table, not the padded shard layout
    z = np.load(ck)
    assert z["leaf_0"].shape[0] == m1.emb.shape[0]
    m2 = train_word2vec_device(ev, cfg, n_aids=20, checkpoint_path=ck,
                               mesh_ctx=mesh)
    np.testing.assert_array_equal(m1.emb, m2.emb)


def test_report_name():
    n = report_name("eval", tag="v1")
    assert n.startswith("eval-")
    assert "v1" in n


def test_describe_numeric():
    d = describe_numeric(np.arange(101))
    assert d["min"] == 0 and d["max"] == 100
    assert d["50%"] == 50


def test_stage_timer():
    t = StageTimer()
    with t.stage("a"):
        pass
    assert "a" in t.stages
    assert "total" in t.report()


def test_time_fn():
    r = time_fn("add", lambda x: x + 1, jnp.zeros(8), iters=2)
    assert r.mean_s >= 0
    assert r.compile_s >= 0
    assert len(r.runs) == 2


def test_time_fn_waits_for_the_result(monkeypatch):
    import jax

    seen = []
    real = jax.block_until_ready
    monkeypatch.setattr(jax, "block_until_ready",
                        lambda x: seen.append(x) or real(x))
    time_fn("add", lambda x: x + 1, jnp.zeros(8), iters=3, warmup=2)
    assert len(seen) == 1 + 1 + 3  # first call, extra warmup, timed runs


def test_per_source_eval_smoke():
    from otto_tpu.data.schema import Labels
    from otto_tpu.engine.retrieval import FEATURE_INDEX, F_TOTAL, RetrievedBatch
    from otto_tpu.eval.per_source import eval_retrieved_by_source, format_report

    S, C = 2, 4
    cand = np.array([[5, 7, -1, -1], [9, -1, -1, -1]], np.int32)
    feats = np.zeros((S, C, F_TOTAL), np.float32)
    feats[:, :, FEATURE_INDEX["src_any"]] = (cand >= 0)
    feats[0, 0, FEATURE_INDEX["src_self"]] = 1
    feats[0, 1, FEATURE_INDEX["src_click_to_click"]] = 1
    b = RetrievedBatch(
        session=np.array([1, 2], np.int32),
        cand=cand,
        feats=feats,
        ts_order=np.zeros((S, C), np.int32),
    )
    labels = Labels(
        session=np.array([1], np.int32),
        type=np.array([0], np.int8),
        aid=np.array([7], np.int32),
    )
    rep = eval_retrieved_by_source([b], labels)
    assert rep["src_any"]["clicks"]["topall"] == 1.0
    assert rep["src_self"]["clicks"]["topall"] == 0.0       # 7 not from self
    assert rep["src_click_to_click"]["clicks"]["topall"] == 1.0
    assert rep["src_click_to_click & not self"]["clicks"]["topall"] == 1.0
    assert "_counts" in rep
    assert "src_any" in format_report(rep)


def test_w2vec_covis_overlap_diagnostic():
    """Overlap semantics (reference: model/w2vec_aids.py:313-318
    'co-countXw2vec' = |co n w2v| / min(20, |co|))."""
    import numpy as np

    from otto_tpu.eval.diagnostics import w2vec_covis_overlap

    # aid 0: co {1,2,3}, w2v {2,3,9} -> 2/3 recovered
    # aid 1: co {5},     w2v {5, 6}  -> 1/1
    # aid 2: no co nbrs -> excluded
    co = np.array([[1, 2, 3], [5, -1, -1], [-1, -1, -1]], np.int32)
    wv = np.array([[2, 3, 9], [5, 6, -1], [7, 8, -1]], np.int32)
    s = w2vec_covis_overlap(wv, co, n_sample=10)
    assert abs(s["co_count_x_w2vec"] - (2 / 3 + 1.0) / 2) < 1e-9
    assert s["n_aids_compared"] == 2
    # reverse direction: aid0 2/3 of w2v backed, aid1 1/2
    assert abs(s["w2vec_x_co_count"] - (2 / 3 + 0.5) / 2) < 1e-9


def test_w2vec_covis_overlap_empty():
    import numpy as np

    from otto_tpu.eval.diagnostics import w2vec_covis_overlap

    z = np.full((4, 3), -1, np.int32)
    s = w2vec_covis_overlap(z, z)
    assert s["n_aids_compared"] == 0



def test_compilation_cache_dir_env_and_default(monkeypatch):
    from pathlib import Path

    from otto_tpu.config import compilation_cache_dir

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert compilation_cache_dir() == "/some/cache"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    root = Path(__file__).resolve().parents[1]
    assert compilation_cache_dir() == str(root / ".jax_cache")
    assert compilation_cache_dir() == compilation_cache_dir()  # fixed


def test_enable_persistent_compilation_cache_sets_jax(monkeypatch, tmp_path):
    import jax

    from otto_tpu.config import enable_persistent_compilation_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert enable_persistent_compilation_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
