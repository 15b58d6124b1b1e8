"""Iterate GBDT ranker configs on persisted downsampled rows (C15 artifact).

run_streaming saves `downsampled-{type}.npz` (feats f16 [N, F], y i8,
session) to the work dir; this script retrains ranker variants on those
rows and reports valid ndcg@20 — no retrieval pass, so a config sweep
costs minutes, not the full pipeline.

Usage:
  python scripts/exp_gbdt_rows.py WORKDIR clicks 'n_trees=300' 'max_depth=6'
  python scripts/exp_gbdt_rows.py WORKDIR all 'n_trees=300,learning_rate=0.15'

Each extra arg is one variant ('key=val,key=val'); '' is the default
config. Prints one JSON line per (type, variant).
"""
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    work = sys.argv[1]
    types = ["clicks", "carts", "orders"] if sys.argv[2] == "all" else [sys.argv[2]]
    variants = sys.argv[3:] or [""]

    from otto_tpu.config import GBDTConfig, enable_persistent_compilation_cache
    from otto_tpu.engine.retrieval import FEATURE_NAMES
    from otto_tpu.models.gbdt import train_gbdt_ranker
    from otto_tpu.models.ranker import ndcg_at_k, _group_pad

    enable_persistent_compilation_cache()

    for tname in types:
        z = np.load(os.path.join(work, f"downsampled-{tname}.npz"))
        # older artifacts were saved pre-clip: f16 inf where counts > 65504
        feats = np.nan_to_num(
            z["feats"].astype(np.float32), posinf=65504.0, neginf=-65504.0
        )
        y = z["y"].astype(np.float32)
        sess = z["session"]
        u_sess = np.unique(sess)
        n_train = max(1, int(len(u_sess) * 0.75))
        vmask = np.isin(sess, u_sess[n_train:])
        tr = (feats[~vmask], y[~vmask], sess[~vmask])
        va = (feats[vmask], y[vmask], sess[vmask])
        print(f"# {tname}: {len(y)} rows, {len(u_sess)} sessions "
              f"({vmask.sum()} valid rows)", file=sys.stderr)

        for v in variants:
            cfg = GBDTConfig()
            if v:
                fields = {}
                for part in v.split(","):
                    k, val = part.split("=")
                    cur = getattr(cfg, k)
                    fields[k] = type(cur)(val)
                cfg = dataclasses.replace(cfg, **fields)
            t0 = time.time()
            model = train_gbdt_ranker(*tr, FEATURE_NAMES, cfg)
            vfg, vlg, vmg = _group_pad(
                va[0], va[1], va[2], cfg.max_group
            )
            vscores = model.predict(
                vfg.reshape(-1, vfg.shape[-1])
            ).reshape(vfg.shape[:2])
            nd = ndcg_at_k(vscores, vlg, vmg, cfg.ndcg_at)
            print(json.dumps({
                "type": tname, "variant": v or "default",
                "valid_ndcg20": round(float(nd), 5),
                "train_s": round(time.time() - t0, 1),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
