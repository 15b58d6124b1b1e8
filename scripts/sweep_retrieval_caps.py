"""Retrieval-cap sweep: quantify the recall/throughput knee of
max_session_aids x max_candidates.

The reference keeps the last 99 events per type per session
(reference: config.py:76-79) and produces up to 2322 candidates/session
(reference: README.md:42-47); the device engine pads to fixed
(max_session_aids, max_candidates) shapes instead (otto_tpu/config.py
RetrievalConfig). This sweep measures, on a LENGTH-SKEWED synthetic set
(heavier tail than the default generator so the caps actually bind),
retrieval-ceiling recall@20-topall and sessions/s per (keep_aids, C) cell,
and writes artifacts/sweep_caps/sweep.json. Sessions/s is a device number
only when the run is on the card.

Usage: python scripts/sweep_retrieval_caps.py
Env: OTTO_SWEEP_SESSIONS (default 30000), OTTO_SWEEP_AIDS (20000)
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> int:
    import logging

    from otto_tpu.config import (
        DEFAULT,
        enable_persistent_compilation_cache,
        setup_logging,
    )
    from otto_tpu.data.split import split_events
    from otto_tpu.data.synthetic import SyntheticSpec, generate
    from otto_tpu.eval.recall import recall_at_k
    from otto_tpu.pipeline.runner import Pipeline

    setup_logging(None, logging.INFO)
    enable_persistent_compilation_cache()
    work = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "artifacts", "sweep_caps")
    NS = int(os.environ.get("OTTO_SWEEP_SESSIONS", 30_000))
    NA = int(os.environ.get("OTTO_SWEEP_AIDS", 20_000))

    # heavier length tail than the default generator: mean ~18, max 512 —
    # p99 unique aids per session comfortably exceeds the smallest cap, so
    # the sweep exercises the truncation the caps impose
    spec = SyntheticSpec(n_sessions=NS, n_aids=NA, mean_len=18.0,
                         max_len=512, span_days=28, seed=3)
    ev = generate(spec)
    sp = split_events(ev, DEFAULT.data.test_days, DEFAULT.data.seed)
    n_test = len(np.unique(sp.test.session))
    ulen = np.unique(sp.test.session, return_counts=True)[1]
    print(f"# {len(ev)} events, {n_test} test sessions, "
          f"test len p50/p99/max = {np.percentile(ulen, 50):.0f}/"
          f"{np.percentile(ulen, 99):.0f}/{ulen.max()}", file=sys.stderr)

    pipe = Pipeline(cfg=DEFAULT, work_dir=work, n_aids=NA)
    retriever = pipe.build_retriever(sp.train, sp.test)

    grid_aids = (32, 64, 99)
    grid_cands = (512, 1024, 2048)
    rows = []
    for ka in grid_aids:
        for mc in grid_cands:
            t = time.time()
            sess_acc, cand_acc = [], []
            for b in retriever.iter_run(sp.test, batch_sessions=512,
                                        keep_aids=ka, max_candidates=mc):
                sess_acc.append(b.session)
                cand_acc.append(b.cand)
            dt = time.time() - t
            sess = np.concatenate(sess_acc)
            cand = np.concatenate(cand_acc)
            rec = recall_at_k(sess, cand, sp.labels, cutoffs=(20,))
            n_cand = float((cand >= 0).sum(axis=1).mean())
            row = {
                "max_session_aids": ka,
                "max_candidates": mc,
                "ceiling_total_topall": rec["total"]["topall"],
                "ceiling_clicks": rec["clicks"]["topall"],
                "ceiling_carts": rec["carts"]["topall"],
                "ceiling_orders": rec["orders"]["topall"],
                "mean_candidates": round(n_cand, 1),
                "sessions_per_s": round(n_test / dt, 1),
                "wall_s": round(dt, 1),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)

    out = {
        "spec": {"n_sessions": NS, "n_aids": NA, "mean_len": 18.0,
                 "max_len": 512, "n_test_sessions": n_test},
        "note": ("reference analogue: last-99-per-type session events "
                 "(config.py:76-79), observed candidates mean 172 / max "
                 "2322 (README.md:42-47)"),
        "grid": rows,
    }
    path = os.path.join(work, "sweep.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=2)
    print(f"# wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
