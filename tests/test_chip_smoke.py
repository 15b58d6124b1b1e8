"""chip_smoke.py on the CPU: the device gate refuses before any work, and
each check runs at a tiny width against its float64 / NumPy reference."""
import json

import numpy as np
import pytest

import chip_smoke as cs


def test_refuses_cpu_before_any_work(monkeypatch, capsys):
    def boom(*a, **k):
        raise AssertionError("work started on a CPU run")

    for phase in ("device_phase", "knn_phase", "transport_phase",
                  "gbdt_phase", "pipeline_phase", "multichip_phase"):
        monkeypatch.setattr(cs, phase, boom)
    assert cs.main([]) != 0
    assert cs.main(["--multichip"]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_knn_phase_small():
    got = cs.knn_phase(np.random.default_rng(0), n_corpus=3000, block=256,
                       n_check=32, stage_queries=1024)
    assert got["knn_overlap"] >= 0.99
    assert got["knn_queries_timed"] == 1024


def test_knn_phase_times_a_fraction_past_budget():
    got = cs.knn_phase(np.random.default_rng(1), n_corpus=3000, block=256,
                       n_check=16, stage_queries=256 * 64, budget_s=0.0)
    assert got["knn_queries_timed"] == 256
    assert got["knn_fraction_of_stage"] == pytest.approx(1 / 64)


def test_transport_phase_small():
    cs.transport_phase(np.random.default_rng(2), S=32, C=300)


def test_gbdt_phase_small():
    cs.gbdt_phase(np.random.default_rng(3), rows=2048)


def test_knn_reference_is_exact_order():
    rng = np.random.default_rng(4)
    corpus = rng.standard_normal((500, 8)).astype(np.float32)
    q = corpus[:7]
    d = ((q[:, None, :].astype(np.float64) - corpus[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(cs.knn_reference(corpus, q, 5),
                                  np.argsort(d, axis=1)[:, :5])


def test_stage_times_from_stage_log(tmp_path):
    log = [{"stage": "covis", "elapsed_s": 2.0, "wall": 112.0},
           {"stage": "w2vec a", "elapsed_s": 5.0, "wall": 115.0},
           {"stage": "score (pass B)", "elapsed_s": 9.0, "wall": 121.5}]
    (tmp_path / "stages.json").write_text(json.dumps(log))
    got = cs.stage_times(str(tmp_path), t_start=100.0)
    assert got == [("generate + split", 10.0), ("covis", 2.0),
                   ("w2vec a", 3.0), ("score (pass B)", 6.5)]


def test_gate_ranked():
    cs.gate_ranked({"total": 0.5, "ceiling_total": 0.6})
    for bad in ({"total": 0.4, "ceiling_total": 0.6},
                {"total": 0.7, "ceiling_total": 0.6},
                {"total": 0.0, "ceiling_total": 0.6}):
        with pytest.raises(cs.SmokeFailure):
            cs.gate_ranked(bad)


def test_default_sessions():
    assert cs.parse_args([]).sessions >= 300_000
    assert cs.parse_args(["--multichip"]).sessions < 300_000
    assert cs.parse_args(["--sessions", "5"]).sessions == 5
