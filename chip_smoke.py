#!/usr/bin/env python3
"""Bring-up check: the OTTO pipeline on a GPU, through its normal entry points.

    python chip_smoke.py                  # one card: device, kernels, pipeline
    python chip_smoke.py --multichip      # four cards: 1-vs-4 mesh check only

Phases, in one process (any failed check or raised error exits non-zero):

  device    refuses to run unless JAX's first device is a GPU; prints the
            device, the card's name and power limit (nvidia-smi), the jax
            and jaxlib versions, XLA_FLAGS and the compile-cache directory
  kernels   every device kernel of the main path against a NumPy float64
            reference at real widths: kNN (plus the time of the kNN stage
            shape), the retrieval transport sort and groupby scan, and GBDT
            scoring
  pipeline  `otto-tpu run-synthetic` with the DEFAULT config at the
            anchor deployment's 1.8M items; checks ranked recall@20 against
            the retrieval ceiling and prints every stage's wall-clock and
            the peak device memory
  multichip (--multichip only, replaces the phases above) the pipeline
            phase's config on one card and on a data=4 mesh: identical
            co-visitation tables, ceilings and ranked metrics within the
            stated tolerances

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

OTTO_SESSIONS = 12_899_779     # the anchor deployment (BASELINE.md)
OTTO_AIDS = 1_800_000
BATCH_SESSIONS = 2048          # the retrieval batch of scale runs
KNN_STAGE_QUERIES = 600_000    # Word2VecConfig.knn_first_n_aids
KNN_TIME_BUDGET_S = 300.0      # past this, a stated fraction is timed


class SmokeFailure(RuntimeError):
    """A check of the smoke run did not hold."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    print(f"  ok: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------
def require_gpu():
    """JAX's devices when the first is a GPU, else None. Runs before any
    other work: a CPU run of this script measures nothing."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        return None
    return devs


def device_phase(devs) -> None:
    import jax
    import jaxlib

    from otto_tpu.config import enable_persistent_compilation_cache

    log(f"device: {devs[0].device_kind} x{len(devs)} "
        f"(platform {devs[0].platform})")
    # a child process that stays off JAX reads the card's name and limit
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log("nvidia-smi --query-gpu=name,power.limit:")
    for line in smi.splitlines():
        log(line)
    log(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {enable_persistent_compilation_cache()}")


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------
def clustered_corpus(rng, n: int, dim: int, per_cluster: int = 100):
    """Embedding-like rows: tight clusters, so the top-k are near
    neighbours whose l2 scores differ in the low digits."""
    centres = rng.standard_normal((max(1, n // per_cluster), dim),
                                  dtype=np.float32)
    which = rng.integers(0, len(centres), n)
    noise = rng.standard_normal((n, dim), dtype=np.float32)
    return centres[which] + np.float32(0.3) * noise


def knn_reference(corpus: np.ndarray, queries: np.ndarray, k: int,
                  chunk: int = 32) -> np.ndarray:
    """Exact float64 l2 top-k indices, brute force."""
    c64 = corpus.astype(np.float64)
    c_sq = np.einsum("vd,vd->v", c64, c64)
    out = np.empty((len(queries), k), np.int64)
    for i in range(0, len(queries), chunk):
        q = queries[i:i + chunk].astype(np.float64)
        d = c_sq[None, :] - 2.0 * q @ c64.T  # + |q|^2, constant per row
        part = np.argpartition(d, k, axis=1)[:, :k]
        order = np.argsort(np.take_along_axis(d, part, 1), axis=1)
        out[i:i + chunk] = np.take_along_axis(part, order, 1)
    return out


def knn_phase(rng, n_corpus: int = OTTO_AIDS, dim: int = 100, k: int = 20,
              block: int = 16384, n_check: int = 256,
              stage_queries: int = KNN_STAGE_QUERIES,
              budget_s: float = KNN_TIME_BUDGET_S) -> dict:
    from otto_tpu.ops.knn import knn_search

    log(f"kNN: corpus {n_corpus} x {dim} f32, k={k}, l2, query block "
        f"{block}; tile product at Precision.HIGHEST (full f32)")
    corpus = clustered_corpus(rng, n_corpus, dim)
    queries = corpus[:block]
    t = time.perf_counter()
    _, idx = knn_search(queries, corpus, k, metric="l2", query_block=block)
    log(f"  first block (compile + run): {time.perf_counter() - t:.3f} s")

    rows = np.sort(rng.choice(block, n_check, replace=False))
    ref = knn_reference(corpus, queries[rows], k)
    overlap = float(np.mean([
        len(set(idx[r].tolist()) & set(ref[j].tolist())) / k
        for j, r in enumerate(rows)
    ]))
    self_nb = float(np.mean(idx[:, 0] == np.arange(block)))
    log(f"  neighbour-set overlap vs float64 ({n_check} queries): "
        f"{overlap:.4f} (need >= 0.99); self-neighbour {self_nb:.4f} "
        "(need 1.00)")
    check(overlap >= 0.99, "kNN neighbour-set overlap >= 0.99")
    check(self_nb == 1.0, "kNN self-neighbour == 1.00")

    # the stage shape: knn_search pads every block to `block` rows, so this
    # reuses the program compiled above; it pulls each block's result to
    # the host, which is where the stage's own call ends as well
    n_blocks = -(-stage_queries // block)
    t = time.perf_counter()
    knn_search(corpus[:block], corpus, k, metric="l2", query_block=block)
    per_block = time.perf_counter() - t
    if per_block * n_blocks <= budget_s:
        q_timed = stage_queries
    else:
        q_timed = max(1, int(budget_s * 0.8 / per_block)) * block
    t = time.perf_counter()
    knn_search(corpus[:q_timed], corpus, k, metric="l2", query_block=block)
    dt = time.perf_counter() - t
    flop = 2.0 * q_timed * n_corpus * dim
    out = {
        "knn_queries_timed": q_timed,
        "knn_fraction_of_stage": q_timed / stage_queries,
        "knn_timed_s": dt,
        "knn_stage_s": dt * stage_queries / q_timed,
        "knn_matmul_tflops": flop / dt / 1e12,
        "knn_overlap": overlap,
    }
    log(f"  stage {stage_queries} x {n_corpus} x {dim}: timed {q_timed} "
        f"queries ({out['knn_fraction_of_stage']:.4f} of the stage) in "
        f"{dt:.3f} s -> {out['knn_stage_s']:.3f} s for the stage; "
        f"{out['knn_matmul_tflops']:.2f} TFLOP/s of tile products")
    return out


def groupby_reference(key, cols):
    """Per-row stable sort by key, then each segment's reduction at its
    last lane, as rowwise_groupby_scan lays it out."""
    S, C = key.shape
    perm = np.argsort(key, axis=1, kind="stable")
    ks = np.take_along_axis(key, perm, 1)
    out = {}
    for name, (arr, red) in cols.items():
        v = np.take_along_axis(arr, perm, 1)
        res = np.zeros_like(v)
        for s in range(S):
            starts = np.flatnonzero(np.r_[True, ks[s, 1:] != ks[s, :-1]])
            ends = np.r_[starts[1:] - 1, C - 1]
            fn = {"sum": np.add, "min": np.minimum, "max": np.maximum}[red]
            res[s, ends] = fn.reduceat(v[s], starts)
        out[name] = res
    return ks, perm, out


def transport_phase(rng, S: int = 2048, C: int = 512) -> None:
    import jax
    import jax.numpy as jnp

    from otto_tpu.ops import segment as seg

    log(f"retrieval transport: [{S}, {C}] int32 and f32 columns, exact "
        "match (f32 values are multiples of 1/8, so every sum is exact in "
        "any order)")
    key = rng.integers(0, 96, (S, C)).astype(np.int32)
    key[rng.random((S, C)) < 0.2] = int(seg.SENTINEL)
    vi = rng.integers(-1000, 1000, (S, C)).astype(np.int32)
    vf = (rng.integers(-512, 512, (S, C)) / 8).astype(np.float32)

    ks, (si, sf) = jax.jit(seg.rowwise_transport_sort)(
        jnp.asarray(key), [jnp.asarray(vi), jnp.asarray(vf)])
    cols = {"i_sum": (vi, "sum"), "i_min": (vi, "min"),
            "f_sum": (vf, "sum"), "f_max": (vf, "max")}
    ks_ref, perm, want = groupby_reference(key, cols)
    check(np.array_equal(np.asarray(ks), ks_ref)
          and np.array_equal(np.asarray(si), np.take_along_axis(vi, perm, 1))
          and np.array_equal(np.asarray(sf), np.take_along_axis(vf, perm, 1)),
          "rowwise_transport_sort == NumPy stable argsort")

    def scan(k, a, b):
        return seg.rowwise_groupby_scan(
            k, {n: ((a if n[0] == "i" else b), r)
                for n, (_, r) in cols.items()})

    ks2, got, is_end, n_unique = jax.jit(scan)(
        jnp.asarray(key), jnp.asarray(vi), jnp.asarray(vf))
    end = np.asarray(is_end)
    ok = np.array_equal(np.asarray(ks2), ks_ref)
    for name in cols:
        ok &= np.array_equal(np.asarray(got[name])[end], want[name][end])
    n_ref = np.array([len(np.unique(r[r != int(seg.SENTINEL)])) for r in key])
    ok &= np.array_equal(np.asarray(n_unique), n_ref)
    check(ok, "rowwise_groupby_scan == NumPy groupby (sum/min/max)")


def gbdt_reference(x, edges, gfeat, thr, leaf):
    """Bins by searchsorted, then a per-level walk of every tree."""
    M, F = x.shape
    T, depth, _ = gfeat.shape
    bins = np.stack([np.searchsorted(edges[f], x[:, f], side="right")
                     for f in range(F)], axis=1)
    node = np.zeros((M, T), np.int64)
    tt = np.arange(T)[None, :]
    rows = np.arange(M)[:, None]
    for level in range(depth):
        f = gfeat[tt, level, node]
        node = node * 2 + (bins[rows, f] >= thr[tt, level, node])
    return node, leaf.astype(np.float64)[tt, node].sum(axis=1)


def gbdt_phase(rng, rows: int = 2048 * 128) -> None:
    import jax.numpy as jnp

    from otto_tpu.config import GBDTConfig
    from otto_tpu.engine.retrieval import FEATURE_NAMES
    from otto_tpu.models.gbdt import (
        _bin_program,
        _predict_program,
        leaf_index_program,
    )

    cfg = GBDTConfig()
    F, T, D, B = len(FEATURE_NAMES), cfg.n_trees, cfg.max_depth, cfg.n_bins
    W = 1 << (D - 1)
    log(f"GBDT scoring: {T} trees, depth {D}, {B} bins, F={F}, M={rows}; "
        "leaf indices exact, scores to 1e-5 of the score scale")
    x = rng.standard_normal((rows, F), dtype=np.float32)
    edges = np.sort(rng.standard_normal((F, B - 1)), axis=1).astype(np.float32)
    gfeat = rng.integers(0, F, (T, D, W)).astype(np.int32)
    thr = rng.integers(1, B + 1, (T, D, W)).astype(np.int32)  # B = no-op
    leaf = (0.1 * rng.standard_normal((T, 1 << D))).astype(np.float32)

    args = [jnp.asarray(a) for a in (x, edges, gfeat, thr, leaf)]
    scores = np.asarray(_predict_program(*args, B))
    node = np.asarray(leaf_index_program(
        _bin_program(args[0], args[1]), args[2], args[3]))
    node_ref, scores_ref = gbdt_reference(x, edges, gfeat, thr, leaf)
    check(np.array_equal(node, node_ref), "GBDT leaf indices == NumPy walk")
    scale = float(np.max(np.abs(scores_ref)))
    err = float(np.max(np.abs(scores - scores_ref)))
    log(f"  max |score - ref| = {err:.3e}, score scale {scale:.3f}")
    check(err <= 1e-5 * scale, "GBDT scores within 1e-5 of the score scale")


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------
def run_pipeline(work_dir: str, sessions: int, aids: int, batch: int,
                 mesh: str | None = None) -> dict:
    """`otto-tpu run-synthetic` in this process; returns its metrics."""
    from otto_tpu.pipeline import cli

    argv = ["run-synthetic", "--sessions", str(sessions), "--aids",
            str(aids), "--batch-sessions", str(batch), "--work-dir",
            work_dir]
    if mesh:
        argv += ["--mesh", mesh]
    log(f"  otto-tpu {' '.join(argv)}")
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t
    if rc != 0:
        raise SmokeFailure(f"run-synthetic exited {rc}")
    metrics = json.loads(buf.getvalue())
    metrics["_wall_s"] = wall
    metrics["_t_start"] = time.time() - wall
    return metrics


def stage_times(work_dir: str, t_start: float) -> list:
    """(stage, seconds) from the pipeline's stages.json: each stage runs
    from the end of the one before it; the first row is data generation
    and the split, up to the start of co-visitation counting."""
    with open(os.path.join(work_dir, "stages.json")) as fh:
        entries = json.load(fh)
    first_start = entries[0]["wall"] - entries[0]["elapsed_s"]
    out = [("generate + split", first_start - t_start)]
    prev = first_start
    for e in entries:
        out.append((e["stage"], e["wall"] - prev))
        prev = e["wall"]
    return out


def gate_ranked(m: dict) -> None:
    total, ceil = m["total"], m["ceiling_total"]
    log(f"  ceiling_total {ceil:.5f}, ranked total {total:.5f} "
        f"(ratio {total / ceil if ceil else float('nan'):.4f})")
    check(0 < total <= ceil, "0 < total <= ceiling_total")
    check(total / ceil >= 0.75, "total / ceiling_total >= 0.75")


def pipeline_phase(sessions: int, tmp: str, aids: int = OTTO_AIDS) -> dict:
    import jax

    log(f"pipeline: DEFAULT config, {aids} items, {sessions} sessions (the "
        f"anchor deployment's {OTTO_SESSIONS} cut "
        f"{OTTO_SESSIONS / sessions:.1f}x to fit one run), batch "
        f"{BATCH_SESSIONS}")
    wd = os.path.join(tmp, "one")
    m = run_pipeline(wd, sessions, aids, BATCH_SESSIONS)
    for stage, sec in stage_times(wd, m["_t_start"]):
        log(f"  stage {stage:<34s} {sec:9.3f} s")
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    log(f"  pipeline wall {m['_wall_s']:.3f} s, peak device memory "
        f"{peak / 2**30:.3f} GiB")
    log("  metrics " + json.dumps(
        {k: v for k, v in m.items() if not k.startswith("_")}))
    gate_ranked(m)
    return m


def load_covis(work_dir: str) -> dict:
    with open(os.path.join(work_dir, "covis.pkl"), "rb") as fh:
        return pickle.load(fh)


# HIGHEST-precision kNN leaves only summation order to differ between the
# one-card and the sharded run; a near-tie neighbour that flips moves a
# candidate in or out of a few sessions' sets
CEILING_TOL = 0.005
# dp-GBDT bags rows per shard by design (tests/test_pipeline_mesh.py)
RANKED_TOL = 0.12


def multichip_phase(sessions: int, devs, tmp: str,
                    aids: int = OTTO_AIDS) -> None:
    if len(devs) < 4:
        raise SmokeFailure(f"--multichip needs 4 GPUs, found {len(devs)}")
    log(f"multichip: DEFAULT config, {aids} items, {sessions} sessions, "
        f"batch {BATCH_SESSIONS}; one card, then --mesh data=4")
    runs = {}
    for name, mesh in (("one", None), ("four", "data=4")):
        wd = os.path.join(tmp, name)
        m = run_pipeline(wd, sessions, aids, BATCH_SESSIONS, mesh)
        log(f"  {name}: wall {m['_wall_s']:.3f} s, " + json.dumps(
            {k: v for k, v in m.items() if not k.startswith("_")}))
        runs[name] = (wd, m)
    (wd1, m1), (wd4, m4) = runs["one"], runs["four"]
    c1, c4 = load_covis(wd1), load_covis(wd4)
    same = c1.keys() == c4.keys() and all(
        len(c1[n]) == len(c4[n])
        and all(np.array_equal(a, b) for a, b in zip(c1[n], c4[n]))
        for n in c1)
    check(same, "sharded co-visitation tables == single-device tables")
    for k in ("ceiling_clicks", "ceiling_carts", "ceiling_orders",
              "ceiling_total"):
        log(f"  {k}: one {m1[k]:.5f}, four {m4[k]:.5f}")
        check(abs(m1[k] - m4[k]) <= CEILING_TOL, f"{k} within {CEILING_TOL}")
    for k in ("clicks", "carts", "orders", "total"):
        log(f"  {k}: one {m1[k]:.5f}, four {m4[k]:.5f}")
        check(abs(m1[k] - m4[k]) <= RANKED_TOL, f"{k} within {RANKED_TOL}")
    gate_ranked(m4)


# ---------------------------------------------------------------------------
def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sessions", type=int, default=None,
                   help="synthetic sessions (default 500000; 20000 with "
                        "--multichip, which runs the pipeline twice on a "
                        "four-card budget)")
    p.add_argument("--multichip", action="store_true",
                   help="run only the 1-vs-4-card mesh check (4 GPUs)")
    args = p.parse_args(argv)
    if args.sessions is None:
        args.sessions = 20_000 if args.multichip else 500_000
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    devs = require_gpu()
    if devs is None:
        print("chip_smoke.py needs a GPU: JAX found no accelerator",
              file=sys.stderr)
        return 2
    device_phase(devs)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="otto_smoke_") as tmp:
        if args.multichip:
            multichip_phase(args.sessions, devs, tmp)
        else:
            rng = np.random.default_rng(0)
            knn_phase(rng)
            transport_phase(rng)
            gbdt_phase(rng)
            pipeline_phase(args.sessions, tmp)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
