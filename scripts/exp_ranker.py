"""Ranker-quality experiment harness.

Runs the pipeline once up to retrieval (C7-C14) on synthetic data, caches
the retrieved candidate/feature/target tensors to disk, then trains and
evaluates ranker variants against the retrieval ceiling. Iterating on
ranker code only pays the (cheap) cache reload, not device retrieval.
Results go to WORK/exp_ranker.json.

Usage:
  python scripts/exp_ranker.py                 # default 20k sessions
  OTTO_EXP_SESSIONS=5000 python scripts/exp_ranker.py mlp gbdt
"""
import json
import logging
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
log = logging.getLogger("exp_ranker")

N_SESSIONS = int(os.environ.get("OTTO_EXP_SESSIONS", 20_000))
N_AIDS = int(os.environ.get("OTTO_EXP_AIDS", 20_000))
WORK = os.environ.get(
    "OTTO_EXP_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "artifacts", f"exp_ranker_{N_SESSIONS}"),
)
CACHE = os.path.join(WORK, "retrieved_cache.npz")


def build_cache():
    from otto_tpu.config import Config, enable_persistent_compilation_cache

    enable_persistent_compilation_cache()
    from otto_tpu.data.split import split_events
    from otto_tpu.data.synthetic import SyntheticSpec, generate
    from otto_tpu.pipeline.runner import Pipeline

    spec = SyntheticSpec(
        n_sessions=N_SESSIONS, n_aids=N_AIDS, mean_len=12, span_days=21, seed=7
    )
    ev = generate(spec)
    sp = split_events(ev, test_days=7, seed=0)
    pipe = Pipeline(cfg=Config(), work_dir=WORK, n_aids=N_AIDS)
    t0 = time.time()
    batches, targets, metrics = pipe.retrieve_with_features(
        sp.train, sp.test, sp.labels, batch_sessions=512
    )
    log.info("retrieval done in %.1fs: %s", time.time() - t0, metrics)

    arrs = {}
    for i, (b, t) in enumerate(zip(batches, targets)):
        arrs[f"session_{i}"] = b.session
        arrs[f"cand_{i}"] = b.cand
        arrs[f"feats_{i}"] = np.asarray(b.feats, np.float16)
        arrs[f"ts_order_{i}"] = b.ts_order
        arrs[f"target_{i}"] = t.astype(np.int8)
    arrs["n_batches"] = np.array(len(batches))
    arrs["labels_session"] = sp.labels.session
    arrs["labels_type"] = sp.labels.type
    arrs["labels_aid"] = sp.labels.aid
    arrs["metrics"] = np.frombuffer(
        json.dumps(metrics).encode(), dtype=np.uint8
    )
    np.savez(CACHE, **arrs)
    log.info("cache written: %s (%.1f MB)", CACHE, os.path.getsize(CACHE) / 1e6)


def load_cache():
    from otto_tpu.data.schema import Labels
    from otto_tpu.engine.retrieval import RetrievedBatch

    z = np.load(CACHE)
    n = int(z["n_batches"])
    batches, targets = [], []
    for i in range(n):
        batches.append(
            RetrievedBatch(
                session=z[f"session_{i}"],
                cand=z[f"cand_{i}"],
                # keep f16: consumers (downsample gather, predict chunks)
                # upcast lazily; a full f32 copy costs ~2 GB RAM at 20k
                feats=z[f"feats_{i}"],
                ts_order=z[f"ts_order_{i}"],
            )
        )
        targets.append(z[f"target_{i}"].astype(np.int32))
    labels = Labels(
        session=z["labels_session"], type=z["labels_type"], aid=z["labels_aid"]
    )
    metrics = json.loads(bytes(z["metrics"].tobytes()).decode())
    return batches, targets, labels, metrics


def eval_variant(name, make_ranker, batches, targets, labels, ceiling):
    """make_ranker(feats, y, sess, valid) -> object with .predict(feats)."""
    from otto_tpu.config import TYPE2ID, TYPES, Config
    from otto_tpu.engine import rank as rank_engine
    from otto_tpu.eval.recall import evaluate_topk

    cfg = Config()
    t0 = time.time()
    preds = {}
    for tname in TYPES:
        feats, y, sess = rank_engine.downsample(
            batches, targets, TYPE2ID[tname], cfg.ranker
        )
        # cache stores f16; trainers (mean/std norm, quantiles) need f32 —
        # f16 accumulation made the MLP normalizer overflow to nan
        feats = feats.astype(np.float32, copy=False)
        u_sess = np.unique(sess)
        n_train = max(1, int(len(u_sess) * 0.75))
        vmask = np.isin(sess, u_sess[n_train:])
        valid = (feats[vmask], y[vmask], sess[vmask])
        tr = (feats[~vmask], y[~vmask], sess[~vmask])
        ranker = make_ranker(tname, *tr, valid)
        s, a, _ = rank_engine.score_and_topk(batches, ranker)
        preds[tname] = (s, a)
    res = evaluate_topk(preds, labels)
    dt = time.time() - t0
    row = {
        "variant": name,
        "time_s": round(dt, 1),
        **{k: round(v, 5) for k, v in res.items()},
        "pct_of_ceiling": round(res["total"] / ceiling, 4),
    }
    print(json.dumps(row))
    return row


def main():
    if not os.path.exists(CACHE) or os.environ.get("OTTO_EXP_REBUILD"):
        build_cache()
    batches, targets, labels, metrics = load_cache()
    ceiling = metrics["ceiling_total"]
    log.info("ceiling metrics: %s", metrics)

    from otto_tpu.config import RankerConfig
    from otto_tpu.engine.retrieval import FEATURE_NAMES
    from otto_tpu.models.ranker import train_ranker

    variants = sys.argv[1:] or ["mlp"]
    rows = []

    for v in variants:
        if v == "mlp":
            def make(tname, f, y, s, valid, _cfg=RankerConfig()):
                return train_ranker(f, y, s, FEATURE_NAMES, _cfg, valid=valid)
            rows.append(eval_variant("mlp-base", make, batches, targets, labels, ceiling))
        elif v.startswith("mlp:"):
            # mlp:key=val,key=val overrides
            kv = dict(p.split("=") for p in v[4:].split(","))
            fields = {}
            for k, val in kv.items():
                cur = getattr(RankerConfig(), k)
                if isinstance(cur, tuple):
                    fields[k] = tuple(int(x) for x in val.split("x"))
                elif isinstance(cur, int):
                    fields[k] = int(val)
                elif isinstance(cur, float):
                    fields[k] = float(val)
                else:
                    fields[k] = val
            import dataclasses
            cfg = dataclasses.replace(RankerConfig(), **fields)
            def make(tname, f, y, s, valid, _cfg=cfg):
                return train_ranker(f, y, s, FEATURE_NAMES, _cfg, valid=valid)
            rows.append(eval_variant(v, make, batches, targets, labels, ceiling))
        elif v == "gbdt" or v.startswith("gbdt:"):
            from otto_tpu.models.gbdt import GBDTConfig, train_gbdt_ranker
            fields = {}
            if v.startswith("gbdt:"):
                kv = dict(p.split("=") for p in v[5:].split(","))
                for k, val in kv.items():
                    cur = getattr(GBDTConfig(), k)
                    fields[k] = type(cur)(val)
            import dataclasses
            cfg = dataclasses.replace(GBDTConfig(), **fields)
            def make(tname, f, y, s, valid, _cfg=cfg):
                return train_gbdt_ranker(f, y, s, FEATURE_NAMES, _cfg, valid=valid)
            rows.append(eval_variant(v, make, batches, targets, labels, ceiling))
        else:
            raise SystemExit(f"unknown variant {v}")

    print("\n=== summary (ceiling_total=%.5f) ===" % ceiling)
    for r in rows:
        print(json.dumps(r))

    # the ranker-vs-ceiling record, next to the per-source retrieval
    # recall report the pipeline wrote during cache build
    out = {
        "spec": {"n_sessions": N_SESSIONS, "n_aids": N_AIDS,
                 "mean_len": 12, "seed": 7},
        "ceiling": {k: round(v, 5) for k, v in metrics.items()},
        "variants": rows,
    }
    path = os.path.join(WORK, "exp_ranker.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=2)
    log.info("wrote %s", path)


if __name__ == "__main__":
    main()
