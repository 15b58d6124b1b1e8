"""Reference-scale pipeline run (BASELINE.json target: full 12.9M-session /
220M-event / 1.8M-aid pipeline on one chip) with per-stage wall-clock +
peak device-memory accounting persisted to WORKDIR/RUN_FULLSCALE.json,
with the device it ran on.

The OTTO dataset itself is not present in this environment, so the run uses
the synthetic generator at reference scale constants (reference:
README.md:9-12 — 12.9M sessions / 220M events / 1.8M aids; the generator
reproduces the structure the pipeline exploits, data/synthetic.py). Stage
wall-clocks are compared against the reference's self-logged CPU ETAs
(BASELINE.md 'Throughput').

Usage:
  OTTO_FS_SESSIONS=12900000 OTTO_FS_AIDS=1800000 python scripts/run_fullscale.py
Knobs: OTTO_FS_SESSIONS/AIDS/MEANLEN/MAXLEN/WORKDIR/BATCH/OUT.
"""
import json
import logging
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from otto_tpu.config import (
    DEFAULT,
    enable_persistent_compilation_cache,
    setup_logging,
)

# BEFORE any jit: generation runs before the Pipeline (which normally
# enables the cache), so its device-walk program is cached as well
enable_persistent_compilation_cache()
from otto_tpu.data.split import split_events
from otto_tpu.data.synthetic import SyntheticSpec, generate, generate_device
from otto_tpu.pipeline.runner import Pipeline

log = logging.getLogger("fullscale")

# reference stage ETAs in seconds (BASELINE.md 'Throughput', self-logged on
# the reference's CPU box at this data scale)
REFERENCE_ETA_S = {
    "covis": (20 + 30) * 60,          # count + merge stages
    "w2vec": 65 * 60,                 # all models
    "session_emb": 12 * 60,
    "kmeans": 24 * 60,
    "popularity": 10 * 60,
    "retrieve+downsample (pass A)": (40 + 5) * 60,
    "rankers": 10 * 60,
    "score (pass B)": 60 * 60,
    "eval_retrieved": 15 * 60,
}


def main() -> int:
    n_sessions = int(os.environ.get("OTTO_FS_SESSIONS", 12_900_000))
    n_aids = int(os.environ.get("OTTO_FS_AIDS", 1_800_000))
    mean_len = float(os.environ.get("OTTO_FS_MEANLEN", 13.4))
    max_len = int(os.environ.get("OTTO_FS_MAXLEN", 128))
    work_dir = os.environ.get("OTTO_FS_WORKDIR", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "artifacts", "fullscale"))
    # 2048-session batches: fewer, larger dispatches per streaming pass
    batch = int(os.environ.get("OTTO_FS_BATCH", 2048))
    out_path = os.environ.get(
        "OTTO_FS_OUT", os.path.join(work_dir, "RUN_FULLSCALE.json"))
    setup_logging(work_dir, logging.INFO)

    record = {
        "spec": {"n_sessions": n_sessions, "n_aids": n_aids,
                 "mean_len": mean_len, "max_len": max_len,
                 "batch_sessions": batch},
        "reference_eta_s": REFERENCE_ETA_S,
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "stages": [],
    }

    def flush():
        # atomic: a kill mid-write must not leave truncated JSON
        tmp = out_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(record, fh, indent=2)
        os.replace(tmp, out_path)

    t0 = time.time()
    spec = SyntheticSpec(n_sessions=n_sessions, n_aids=n_aids,
                         mean_len=mean_len, max_len=max_len,
                         span_days=28, seed=7)
    # events cache: restarts of a multi-hour run must not pay the ~15-min
    # generation again (and bit-identical data keeps every downstream
    # artifact cache coherent — recompiled generators are not bit-stable
    # across launches, measured 0.15% event drift run-to-run)
    data_cache = os.path.join(work_dir, "events.npz")
    os.makedirs(work_dir, exist_ok=True)
    if os.path.exists(data_cache):
        from otto_tpu.data.schema import Events

        z = np.load(data_cache)
        ev = Events(z["session"], z["aid"], z["ts"], z["type"])
        record["generator"] = "cache"
    # device generation by default: the host NumPy walk is single-core
    # and takes tens of minutes at this scale
    elif os.environ.get("OTTO_FS_GEN", "device") == "device":
        ev = generate_device(spec)
        record["generator"] = "device"
    else:
        ev = generate(spec)
        record["generator"] = "host"
    if record["generator"] != "cache":
        np.savez(data_cache, session=ev.session, aid=ev.aid, ts=ev.ts,
                 type=ev.type)
    record["n_events"] = int(len(ev))
    record["stages"].append({"stage": "generate",
                             "elapsed_s": round(time.time() - t0, 1)})
    log.info("generated %d events (%.1f per session)", len(ev),
             len(ev) / n_sessions)
    flush()

    t1 = time.time()
    sp = split_events(ev, DEFAULT.data.test_days, DEFAULT.data.seed)
    del ev
    record["n_train_events"] = int(len(sp.train))
    record["n_test_sessions"] = int(len(np.unique(sp.test.session)))
    record["stages"].append({"stage": "split",
                             "elapsed_s": round(time.time() - t1, 1)})
    log.info("split: train=%d test_sessions=%d labels=%d",
             len(sp.train), record["n_test_sessions"], len(sp.labels))
    flush()

    import dataclasses

    cfg = DEFAULT
    if os.environ.get("OTTO_FS_DEVSELECT", "1") == "1":
        # device-side downsample keep bits: the host selection's three
        # [2048, 512] argsorts per batch move to the device
        # (RankerConfig.device_select)
        cfg = dataclasses.replace(
            cfg, ranker=dataclasses.replace(cfg.ranker, device_select=True)
        )
    pipe = Pipeline(cfg=cfg, work_dir=work_dir, n_aids=n_aids)
    t2 = time.time()

    n_fixed = len(record["stages"])  # generate + split rows stay in place

    def snapshot_stages():
        # stage_log entries carry elapsed-since-phase-t0; convert to deltas
        del record["stages"][n_fixed:]
        prev = 0.0
        for e in list(pipe.stage_log):
            d = dict(e)
            el = d["elapsed_s"]
            d["delta_s"] = round(el - prev if el >= prev else el, 1)
            prev = el if el >= prev else el
            record["stages"].append(d)
        record["pipeline_s_so_far"] = round(time.time() - t2, 1)

    # a multi-hour run must leave a usable record even if the process is
    # killed mid-stage: poll the runner's stage log and flush every 30 s
    import threading

    stop = threading.Event()

    def poller():
        while not stop.wait(30.0):
            snapshot_stages()
            flush()

    poll_thread = threading.Thread(target=poller, daemon=True)
    poll_thread.start()

    try:
        metrics = pipe.run_streaming(sp.train, sp.test, sp.labels,
                                     batch_sessions=batch)
        record["metrics"] = metrics
    finally:
        stop.set()
        poll_thread.join()  # an in-flight poll must not race the final flush
        snapshot_stages()
        record["pipeline_s"] = round(time.time() - t2, 1)
        record["total_s"] = round(time.time() - t0, 1)
        flush()
    log.info("DONE in %.1fs: %s", record["total_s"],
             json.dumps(record.get("metrics", {})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
