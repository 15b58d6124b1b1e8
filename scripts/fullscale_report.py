"""Render RUN_FULLSCALE.json into the per-stage comparison table vs the
reference's self-logged ETAs (BASELINE.md 'Throughput') in markdown.

The run may have resumed covis/w2vec from artifact caches (the reference
resumes from its chunk caches the same way); pass --covis-s/--w2vec-s to
substitute the measured wall-clock of the run that actually built the
artifact, so the table reflects true stage costs.
"""
import argparse
import json

REF = [
    # (stage-prefix, reference seconds, reference description)
    ("covis", 3000, "count 20 min + merge 30 min"),
    ("w2vec", 3900, "4 models, 65 min, 16 threads"),
    ("session_emb", 720, "12 min"),
    ("kmeans", 1440, "24 min"),
    ("popularity", 600, "10 min"),
    ("retrieve+downsample", 2700, "retrieve 40 + downsample 5 min"),
    ("eval_retrieved", 900, "15 min"),
    ("ranker", 600, "LightGBM 5-10 min"),
    ("score", 3600, "60 min"),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("record", help="a run_fullscale.py record")
    ap.add_argument("--covis-s", type=float, default=None,
                    help="substitute covis seconds (artifact-cache resume)")
    ap.add_argument("--w2vec-s", type=float, default=None)
    ap.add_argument("--sub", action="append", default=[],
                    metavar="STAGE=SECONDS",
                    help="substitute any stage's seconds (repeatable), for "
                    "stages resumed from artifact caches in this record — "
                    "use the measured wall-clock of the run that actually "
                    "built the artifact")
    args = ap.parse_args()
    d = json.load(open(args.record))

    stages = {}
    for s in d.get("stages", []):
        name = s["stage"]
        dt = s.get("delta_s", s.get("elapsed_s", 0.0))
        key = name.split(" (")[0]
        for pref, _, _ in REF:
            if key.startswith(pref.split("+")[0]) or key.startswith(pref):
                key = pref
                break
        if name.startswith("w2vec"):
            key = "w2vec"
        if name.startswith("ranker"):
            key = "ranker"
        if name.startswith("score"):
            key = "score"
        if name.startswith("retrieve+downsample"):
            key = "retrieve+downsample"
        stages[key] = stages.get(key, 0.0) + dt
    if args.covis_s is not None:
        stages["covis"] = args.covis_s
    if args.w2vec_s is not None:
        stages["w2vec"] = args.w2vec_s
    for sub in args.sub:
        k, _, v = sub.partition("=")
        stages[k] = float(v)

    dev = d.get("device", {})
    label = f"otto ({dev.get('count', '?')}x {dev.get('kind', 'unrecorded device')})"
    print(f"| Stage | reference (CPU box) | {label} | speedup |")
    print("|---|---|---|---|")
    tot_ref = tot_us = 0.0
    for pref, ref_s, desc in REF:
        us = stages.get(pref)
        if us is None:
            continue
        tot_ref += ref_s
        tot_us += us
        print(f"| {pref} | {ref_s/60:.0f} min ({desc}) | {us/60:.1f} min "
              f"| {ref_s/us:.1f}x |")
    extra = sum(v for k, v in stages.items()
                if not any(k == p for p, _, _ in REF))
    print(f"| other (submit/eval/ctx) | — | {extra/60:.1f} min | — |")
    print(f"| **pipeline total** | **{tot_ref/60:.0f} min** | "
          f"**{(tot_us+extra)/60:.1f} min** | "
          f"**{tot_ref/(tot_us+extra):.1f}x** |")
    for k in ("generate", "split"):
        if k in stages:
            print(f"| {k} (dataset prep, not in reference total) | — | "
                  f"{stages[k]/60:.1f} min | — |")

    m = d.get("metrics", {})
    if m:
        print()
        print("| Quality (synthetic 12.9M-session dataset) | value | "
              "reference (real OTTO) |")
        print("|---|---|---|")
        print(f"| retrieval ceiling recall@20 total | "
              f"{m.get('ceiling_total', 0):.4f} | 0.637356 |")
        print(f"| submission recall@20 total | {m.get('total', 0):.4f} | "
              "0.566174 |")
        if m.get("ceiling_total"):
            print(f"| ranker / ceiling ratio | "
                  f"{m.get('total', 0)/m['ceiling_total']:.3f} | ~0.888 |")
        print(f"| candidates/session mean/min/max | "
              f"{m.get('cand_per_session_mean', 0):.1f} / "
              f"{m.get('cand_per_session_min', 0)} / "
              f"{m.get('cand_per_session_max', 0)} | 172.4 / 56 / 2322 |")


if __name__ == "__main__":
    main()
