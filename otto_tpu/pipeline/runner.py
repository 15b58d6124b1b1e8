"""Pipeline orchestrator.

The reference is 15 manually-ordered CLI scripts communicating via parquet
files (reference: README.md:282-368, SURVEY.md §1 'Control flow between
layers is manual'). Here the same stages are a declared DAG with artifact-
based resumability: every stage persists its outputs under the work dir and
is skipped when they already exist (the reference's ad-hoc 'skip if output
file exists' checks, e.g. model/count_co_events.py:84-89 and
model/w2vec_aids.py:49-53, made systematic).

Stages (reference step numbers from README.md:282-368):
  synth/ingest -> split -> covis -> w2vec x2 -> knn -> session_emb
  -> kmeans -> popularity -> retrieve -> downsample -> rankers x3
  -> rank -> submit -> eval
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import pickle
import time
from pathlib import Path
from typing import Dict, List, Optional

import jax.numpy as jnp
import numpy as np

from otto_tpu.config import TYPE2ID, TYPES, Config
from otto_tpu.data.batching import pack_sessions
from otto_tpu.data.schema import Events, Labels
from otto_tpu.data.split import split_events
from otto_tpu.data.synthetic import SyntheticSpec, generate
from otto_tpu.engine import rank as rank_engine
from otto_tpu.engine.covis import CoVisCounter
from otto_tpu.engine.popularity import compute_popularity
from otto_tpu.engine.retrieval import (
    FEATURE_NAMES,
    RetrievalContext,
    RetrievedBatch,
    Retriever,
    join_labels,
)
from otto_tpu.engine.session_embed import build_knn_tables, compute_session_embeddings
from otto_tpu.eval.recall import evaluate_topk, recall_at_k
from otto_tpu.models.ranker import Ranker, train_ranker
from otto_tpu.models.word2vec import (
    Word2Vec,
    train_word2vec,
    train_word2vec_device,
)
from otto_tpu.ops.kmeans import kmeans_fit

log = logging.getLogger(__name__)


def _host_rss_gb() -> float:
    """Resident host memory of this process (OOM forensics for scale
    runs)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 2**20
    except OSError:
        pass
    return 0.0


def _peak_device_gb() -> "Optional[float]":
    """Peak device memory of the first local device in GiB (SURVEY §5.1
    observability); None where the backend keeps no memory stats."""
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use") or stats.get("bytes_in_use")
    return round(peak / 2**30, 2) if peak else None


@dataclasses.dataclass
class Pipeline:
    """cfg/work_dir/n_aids: see module docstring. `mesh` (a
    parallel.mesh.MeshContext) turns on multi-device execution: co-vis
    counting runs sharded with all-to-all count exchange, KMeans and the
    GBDT rankers run data-parallel (histogram/centroid psum), and retrieval
    batches are sharded over the data axis. mesh=None (default) is the
    single-device path; both produce identical artifacts and metrics
    (mesh-size invariance is tested on the virtual CPU mesh)."""

    cfg: Config
    work_dir: str
    n_aids: int
    use_cache: bool = True
    mesh: "Optional[object]" = None     # parallel.mesh.MeshContext

    def __post_init__(self):
        Path(self.work_dir).mkdir(parents=True, exist_ok=True)
        from otto_tpu.config import (
            config_to_json,
            enable_persistent_compilation_cache,
        )

        enable_persistent_compilation_cache()
        # persist the config next to the artifacts it shapes, so inference-
        # only runs (CLI rank) can reload the exact training configuration —
        # and GUARD against resuming over a stale cache: artifacts written
        # under a different config/n_aids are silently wrong (e.g. a vocab
        # holding aid ids past the current n_aids), so a mismatch with
        # use_cache=True fails fast here instead of deep inside a stage.
        # work_dir and mesh are excluded: neither shapes artifact content
        # (mesh-size invariance is tested at pipeline level).
        cpath = self._p("config.json")
        cur = json.loads(json.dumps(dataclasses.asdict(self.cfg)))
        for k in ("work_dir", "mesh"):
            cur.pop(k, None)
        if os.path.exists(cpath) and self.use_cache:
            with open(cpath) as fh:
                stored = json.load(fh)
            for k in ("work_dir", "mesh"):
                stored.pop(k, None)
            if stored != cur:
                diff = [k for k in cur if stored.get(k) != cur[k]]
                raise ValueError(
                    f"work dir {self.work_dir!r} holds artifacts for a "
                    f"DIFFERENT config (mismatched sections: {diff}); use a "
                    "fresh work dir or use_cache=False"
                )
        else:
            config_to_json(self.cfg, cpath)
        mpath = self._p("meta.json")
        if os.path.exists(mpath) and self.use_cache:
            with open(mpath) as fh:
                meta = json.load(fh)
            if meta.get("n_aids") != self.n_aids:
                raise ValueError(
                    f"work dir {self.work_dir!r} holds artifacts for "
                    f"n_aids={meta.get('n_aids')} (got {self.n_aids}); use "
                    "a fresh work dir or use_cache=False"
                )
        else:
            with open(mpath, "w") as fh:
                json.dump({"n_aids": self.n_aids}, fh)
        # machine-readable stage log (stage, elapsed seconds since the
        # owning phase's t0, wall-clock time at the stage's end, peak device
        # memory), rewritten to stages.json in the work dir after each stage
        self.stage_log: List[Dict] = []

    def _p(self, name: str) -> str:
        return os.path.join(self.work_dir, name)

    def _cached(self, name: str) -> bool:
        return self.use_cache and os.path.exists(self._p(name))

    def _log(self, stage: str, t0: float, msg: str = ""):
        el = time.time() - t0
        entry = {"stage": stage, "elapsed_s": round(el, 1),
                 "wall": time.time(), "rss_gb": round(_host_rss_gb(), 1)}
        peak = _peak_device_gb()
        if peak is not None:
            entry["peak_device_gb"] = peak
        if msg:
            entry["msg"] = msg
        self.stage_log.append(entry)
        with open(self._p("stages.json"), "w") as fh:
            json.dump(self.stage_log, fh, indent=1)
        log.info("[%7.1fs] %s %s", el, stage, msg)

    # ------------------------------------------------------------------
    def run(
        self,
        train: Events,
        test: Events,
        labels: Optional[Labels] = None,
        batch_sessions: int = 256,
    ) -> Dict[str, float]:
        """Run the full offline pipeline; returns eval metrics.

        Without labels this is the reference's production inference path
        (reference: model/rank.py:17-61, model/submit.py:14-61): previously
        trained rankers are loaded from the work dir and applied to the
        unlabeled test set; submission.csv is still written (metrics stay
        empty)."""
        batches, targets, metrics = self.retrieve_with_features(
            train, test, labels, batch_sessions=batch_sessions
        )
        if labels is not None:
            self.rank_and_eval(batches, targets, labels, metrics)
        else:
            t0 = time.time()
            rankers = self.load_rankers()
            preds = {}
            for tname in TYPES:
                s, a, _ = rank_engine.score_and_topk(batches, rankers[tname])
                preds[tname] = (s, a)
            self._submit_and_eval(preds, None, metrics, t0)
        return metrics

    def run_streaming(
        self,
        train: Events,
        test: Events,
        labels: Optional[Labels] = None,
        batch_sessions: int = 512,
    ) -> Dict[str, float]:
        """Full pipeline at scale: identical metrics to run(), O(one batch)
        device feature memory. run() keeps every retrieval batch's
        [S, C, F] tensor resident (~200 KB/session, 10 GB at 50k test
        sessions); here the candidate store is consumed as a stream
        instead:

          pass A: retrieve -> per-batch label join + negative downsample
                  (small selected-row gathers cross the link), src-flag
                  slice for the per-source report, ceiling-eval ids;
          train : 3 rankers from the accumulated downsampled rows;
          pass B: re-retrieve -> score + top-20 on device ([S, 20] pulls).

        Re-retrieval costs one extra pass through the (compile-cached)
        retrieval program instead of spilling the [S, C, F] feature
        tensors over the host link."""
        t0 = time.time()
        cfg = self.cfg
        retriever = self.build_retriever(train, test)

        if labels is None:
            # inference-only: no label join / downsample / training — load
            # persisted rankers and do the scoring pass directly
            # (reference: model/rank.py:17-61 scores unlabeled test chunks
            # with previously trained boosters)
            rankers = self.load_rankers()
            preds = self._score_pass(retriever, test, rankers, batch_sessions)
            self._log("score (inference-only)", t0)
            return self._submit_and_eval(preds, None, {}, t0)

        from otto_tpu.eval.per_source import SrcFlagBatch

        # crash-resume fast path (a mid-training or mid-pass-B crash must
        # not cost another ~70-min pass A at reference scale): when the
        # pass-A metrics snapshot is cached and every target has EITHER a
        # trained ranker artifact OR its persisted downsampled rows (the
        # C15 artifact, written before any training), skip pass A entirely
        # — train any missing rankers from the persisted rows, then score
        backend = cfg.ranker_backend
        pm_path = self._p("passA-metrics.json")

        def _load_rows(tname):
            # reload the persisted C15 artifact instead of keeping ~25 GB
            # of f16 rows resident across all three targets (host OOM risk
            # at reference scale)
            z = np.load(self._p(f"downsampled-{tname}.npz"))
            return z["feats"], z["y"], z["session"]

        if (
            self.use_cache
            and os.path.exists(pm_path)
            and all(
                self._cached(f"ranker-{backend}-{t}.npz")
                or self._cached(f"downsampled-{t}.npz")
                for t in TYPES
            )
        ):
            with open(pm_path) as fh:
                metrics = json.load(fh)
            rankers = {
                t: self._train_ranker_cached(t, lambda t=t: _load_rows(t), t0)
                for t in TYPES
            }
            self._log("pass A + rankers (cached)", t0)
            preds = self._score_pass(retriever, test, rankers, batch_sessions)
            self._log("score (pass B)", t0)
            return self._submit_and_eval(preds, labels, metrics, t0)

        rngs = {t: np.random.default_rng(42) for t in TYPES}
        # device-side downsample selection (keep bits fused into the
        # pass-A meta dispatch; RankerConfig.device_select)
        dev_sel = bool(getattr(cfg.ranker, "device_select", False))
        rows = {t: [] for t in TYPES}    # downsampled (feats, y, sess)
        sess_acc, cand_acc, flag_batches = [], [], []
        n_sessions = 0
        # device-side streaming evaluator (ceiling + per-source + count
        # stats accumulated per batch ON DEVICE; a few KB pulled once at
        # the end). The host fallback below materialized 18 masked copies
        # of the full candidate matrix after the pass — ~33 min + several
        # GB of host RAM at reference scale. Created on the first
        # device-path batch (host-array batches keep the host path).
        dev_eval = None

        cand_counts = []   # candidates/session (reference README.md:42-47
        #                    anchor: mean 172.354, min 56, max 2322)

        # phase accounting for the consumer's per-batch serial chain
        ph = {"meta_pull": 0.0, "join": 0.0, "select": 0.0,
              "gather": 0.0, "rows_pull": 0.0}
        n_batches = 0
        # one-batch deferred row materialization: batch N's selected-row
        # pull transfers (copy_to_host_async) while batch N+1's numpy
        # join/select runs — (handle, n, layout) of the previous batch
        pend: list = []

        def flush_pend():
            handle, n, layout = pend.pop(0)
            # exact-size copy: slicing the pow2-PADDED pull without a copy
            # keeps the padded base array alive via the per-target views —
            # up to 2x the rows' true footprint held for the whole pass
            feats_all = np.asarray(handle)[:n].copy()
            off = 0
            for tname, cnt, y, sess in layout:
                rows[tname].append((feats_all[off:off + cnt], y, sess))
                off += cnt

        def consume_a(b, meta=None):
            nonlocal n_sessions, n_batches, dev_eval
            # ONE packed pull covers cand + src flags (pack_meta) instead of
            # a lazy-cand pull and a flag pull per batch. With pack_meta_labels the label join rides
            # the same dispatch: a second small [S, C] u8 pull replaces
            # the host searchsorted join (~420 ms/batch measured).
            t = time.time()
            tbits = None
            if isinstance(meta, tuple):
                meta_i32, tbits_dev = meta
                if dev_eval is None:
                    if n_batches:
                        raise RuntimeError(
                            "mixed device/host retrieval batches in one "
                            "streaming pass"
                        )
                    from otto_tpu.eval.per_source import DeviceSourceEval

                    dev_eval = DeviceSourceEval(int(b.feats.shape[1]))
                # async accumulate dispatch BEFORE the blocking pulls
                dev_eval.update(meta_i32, tbits_dev)
                flags_packed = b.unpack_meta(meta_i32)
                tbits = np.asarray(tbits_dev)
            else:
                if dev_eval is not None:
                    raise RuntimeError(
                        "mixed device/host retrieval batches in one "
                        "streaming pass"
                    )
                flags_packed = b.unpack_meta(meta) if meta is not None else None
            ph["meta_pull"] += time.time() - t
            n_sessions += len(b.session)
            n_batches += 1
            if dev_eval is None:
                sess_acc.append(b.session)
                cand_acc.append(b.cand)
                cand_counts.append((b.cand >= 0).sum(axis=1))
            if labels is None:
                return
            if dev_eval is None:
                flag_batches.append(
                    SrcFlagBatch(b.session, b.cand, flags_packed)
                    if flags_packed is not None
                    else SrcFlagBatch.from_batch(b)
                )
            t = time.time()
            if tbits is not None:
                tgt = None
                if not dev_sel:
                    tgt = np.stack(
                        [(tbits >> ti) & 1 for ti in range(3)], axis=-1
                    ).astype(np.float32)
            else:
                tgt = join_labels([b], labels)[0]
            ph["join"] += time.time() - t
            # select per type: device keep bits (bits 3-5 of the tbits
            # pull, RankerConfig.device_select) reduce the host's share to
            # np.nonzero; the host fallback runs three [S, C] argsorts.
            # Either way, ONE padded device gather then covers all three
            # types (one dispatch and one pull instead of three)
            t = time.time()
            sels = {}
            if dev_sel and tbits is not None:
                for tname in TYPES:
                    tid = TYPE2ID[tname]
                    si, ci = np.nonzero((tbits >> (3 + tid)) & 1)
                    if len(si) == 0:
                        continue
                    y = ((tbits[si, ci] >> tid) & 1).astype(np.float32)
                    sels[tname] = (si, ci, y)
            else:
                for tname in TYPES:
                    got = rank_engine.downsample_select(
                        b, tgt, TYPE2ID[tname], cfg.ranker, rngs[tname]
                    )
                    if got is not None:
                        sels[tname] = got
            ph["select"] += time.time() - t
            if sels:
                si_all = np.concatenate([s[0] for s in sels.values()])
                ci_all = np.concatenate([s[1] for s in sels.values()])
                # accumulate f16: the C15 artifact persists f16 anyway and
                # the full-scale clicks target (~70M rows x 104) would hold
                # ~29 GB as f32 on the host. Clipped into f16 range on
                # device: values past 65504 share the top quantile bin, inf
                # would poison binning.
                t = time.time()
                handle, n = b.feats_rows_async(si_all, ci_all)
                layout = [
                    (tname, len(s[0]), s[2], b.session[s[0]])
                    for tname, s in sels.items()
                ]
                pend.append((handle, n, layout))
                ph["gather"] += time.time() - t
                t = time.time()
                while len(pend) > 1:
                    flush_pend()
                ph["rows_pull"] += time.time() - t
            if n_batches % 128 == 0:
                tot = sum(ph.values())
                log.info(
                    "pass A consumer after %d batches: %s (%.0f ms/batch "
                    "consumed, rss %.1f GB)",
                    n_batches,
                    {k: f"{v / n_batches * 1e3:.0f}ms" for k, v in ph.items()},
                    tot / n_batches * 1e3,
                    _host_rss_gb(),
                )

        # pipelined consumer thread: batch N's host-side pulls + label
        # join + downsample run on a worker thread while the main thread
        # keeps dispatching batch N+1's retrieval, so host work overlaps
        # device work. Queue depth 1 bounds live [S, C, F] feature tensors
        # to ~3 batches.
        from otto_tpu.engine.retrieval import label_keys_device

        lab_keys = label_keys_device(labels)
        if dev_sel:
            import jax

            sel_key = jax.random.PRNGKey(cfg.ranker.seed)
            bidx = [0]  # producer thread only: sequential, no race

            def _pack(b):
                k = jax.random.fold_in(sel_key, bidx[0])
                bidx[0] += 1
                got = b.pack_meta_labels_select(
                    lab_keys, k, cfg.ranker.neg_to_pos_ratio,
                    cfg.ranker.max_neg_per_session,
                )
                return got or b.pack_meta()
        else:
            def _pack(b):
                return b.pack_meta_labels(lab_keys) or b.pack_meta()

        self._pipelined_consume(
            retriever.iter_run(test, batch_sessions=batch_sessions),
            consume_a,
            pack=_pack,
        )
        while pend:
            flush_pend()
        self._log(
            "retrieve+downsample (pass A)", t0,
            f"{n_sessions} sessions; consumer phases (ms/batch): "
            + json.dumps({k: round(v / max(1, n_batches) * 1e3)
                          for k, v in ph.items()}),
        )

        metrics: Dict[str, float] = {}
        if dev_eval is not None:
            from otto_tpu.eval.per_source import format_report

            report = dev_eval.finalize(labels)
            ceiling = report.pop("_ceiling")
            with open(self._p("eval_retrieved.json"), "w") as fh:
                json.dump(ceiling, fh, indent=2)
            for t in ("clicks", "carts", "orders", "total"):
                metrics[f"ceiling_{t}"] = ceiling[t]["topall"]
            self._log("eval_retrieved", t0, json.dumps(ceiling["total"]))
            with open(self._p("eval_retrieved_sources.json"), "w") as fh:
                json.dump(report, fh, indent=2)
            log.info("per-source recall:\n%s", format_report(report))
            self._log("eval per-source", t0)
            anyc = report["_counts"]["src_any"]
            metrics["cand_per_session_mean"] = anyc["mean"]
            metrics["cand_per_session_min"] = anyc["min"]
            metrics["cand_per_session_max"] = anyc["max"]
            log.info(
                "candidates/session: mean %.1f min %d max %d "
                "(reference: 172.4 / 56 / 2322, README.md:42-47)",
                anyc["mean"], anyc["min"], anyc["max"],
            )
        else:
            metrics = self._eval_retrieved(
                np.concatenate(sess_acc), np.concatenate(cand_acc),
                flag_batches, labels, t0,
            )
            del flag_batches, sess_acc, cand_acc
            # candidate-count distribution vs the reference's published
            # stats (reference: README.md:42-47 — mean 172.354, min 56,
            # max 2322; a shape mismatch here catches silent retrieval
            # bugs that recall on synthetic data cannot)
            cc = np.concatenate(cand_counts)
            metrics["cand_per_session_mean"] = float(cc.mean())
            metrics["cand_per_session_min"] = int(cc.min())
            metrics["cand_per_session_max"] = int(cc.max())
            log.info(
                "candidates/session: mean %.1f min %d max %d "
                "(reference: 172.4 / 56 / 2322, README.md:42-47)",
                cc.mean(), cc.min(), cc.max(),
            )
            del cand_counts, cc
        # pass-A metrics snapshot: together with the ranker artifacts this
        # lets a crash-restart skip straight to pass B (fast path above)
        with open(pm_path, "w") as fh:
            json.dump(metrics, fh, indent=2)

        # persist EVERY target's downsampled training set (the reference's
        # C15 stage artifact, reference: model/downsample_retrieved.py:61-62
        # per-target dirs) BEFORE any ranker trains: a crash mid-training
        # must not lose another target's pass-A rows (ranker iteration also
        # reuses these, scripts/exp_gbdt_rows.py)
        for tname in TYPES:
            if self._cached(f"ranker-{backend}-{tname}.npz"):
                rows[tname] = None
                continue
            if not rows[tname]:
                raise ValueError(f"no positive sessions for {tname}")
            feats = np.concatenate([r[0] for r in rows[tname]])
            y = np.concatenate([r[1] for r in rows[tname]])
            sess = np.concatenate([r[2] for r in rows[tname]])
            rows[tname] = None  # free
            order = np.argsort(sess, kind="stable")
            feats, y, sess = feats[order], y[order], sess[order]
            np.savez(
                self._p(f"downsampled-{tname}.npz"),
                feats=feats,  # already clipped f16 at accumulation
                y=y.astype(np.int8),
                session=sess,
            )
            n_rows = len(y)
            # freed here, reloaded per target at training time: holding all
            # three targets' rows (~25+ GB f16 at reference scale) across
            # the whole training phase exhausts host RAM at reference scale
            del feats, y, sess, order
            self._log(f"downsample {tname} persisted", t0, f"{n_rows} rows")

        rankers: Dict[str, object] = {}
        for tname in TYPES:
            rankers[tname] = self._train_ranker_cached(
                tname, lambda tname=tname: _load_rows(tname), t0
            )

        # pass B: stream again, score all 3 targets per batch on device
        preds = self._score_pass(retriever, test, rankers, batch_sessions)
        self._log("score (pass B)", t0)
        return self._submit_and_eval(preds, labels, metrics, t0)

    def _pipelined_consume(
        self, batch_iter, consume, with_meta=True, pack=None
    ) -> None:
        """Producer/consumer pipeline over retrieval batches: the main
        thread dispatches device work (retrieval + the packed meta
        program) while a worker thread does the per-batch host work
        (pulls, joins, downsampling / scoring collection). `pack`
        overrides the per-batch device-side pack dispatch (default
        b.pack_meta()); tuple results have every element's host copy
        started asynchronously. Queue depth 1: at most ~3 batches' device
        tensors are alive (in-flight retrieve, queued, being consumed).
        On a consumer error the worker keeps draining so the producer
        never blocks; the error re-raises here."""
        import queue as queue_mod
        import threading

        q: "queue_mod.Queue" = queue_mod.Queue(maxsize=1)
        errs: list = []

        def drain():
            while True:
                item = q.get()
                if item is None:
                    return
                if errs:
                    continue  # discard so the producer's put() never blocks
                try:
                    consume(*item)
                except BaseException as e:
                    errs.append(e)

        worker = threading.Thread(target=drain, daemon=True,
                                  name="pipeline-consume")
        worker.start()
        try:
            for b in batch_iter:
                if errs:
                    break
                if pack is not None:
                    meta = pack(b)
                else:
                    meta = b.pack_meta() if with_meta else None
                # start the device->host copies now: the transfers ride
                # the link while the consumer works on earlier batches,
                # so its np.asarray(...) finds the bytes already here
                for h in meta if isinstance(meta, tuple) else (meta,):
                    if h is not None:
                        try:
                            h.copy_to_host_async()
                        except AttributeError:
                            pass
                q.put((b, meta))
        finally:
            q.put(None)
            worker.join()
        if errs:
            raise errs[0]

    def _score_pass(self, retriever, test, rankers, batch_sessions):
        """One streaming scoring pass: re-retrieve, score all 3 targets per
        batch on device, pull ONE stacked [3, S, 20] aid tensor per batch
        (score_topk_multi), with the host pulls pipelined against the next
        batch's retrieval (_pipelined_consume)."""
        pieces = {t: ([], []) for t in TYPES}
        ranker_list = [rankers[t] for t in TYPES]

        def consume_b(b, meta=None):
            del meta  # pass B needs no host cand/flags: top-k is on device
            multi = rank_engine.score_topk_multi(b, ranker_list)
            if multi is not None:
                for i, tname in enumerate(TYPES):
                    pieces[tname][0].append(b.session)
                    pieces[tname][1].append(multi[i])
                return
            for tname in TYPES:
                s, a, _ = rank_engine.score_and_topk([b], rankers[tname])
                pieces[tname][0].append(s)
                pieces[tname][1].append(a)

        self._pipelined_consume(
            retriever.iter_run(test, batch_sessions=batch_sessions),
            consume_b, with_meta=False,
        )
        preds = {}
        for tname in TYPES:
            s = np.concatenate(pieces[tname][0])
            a = np.concatenate(pieces[tname][1])
            order = np.argsort(s, kind="stable")
            preds[tname] = (s[order], a[order])
        return preds

    def load_rankers(self) -> Dict[str, object]:
        """Load the 3 persisted rankers (reference: model/rank.py:41-42
        loads boosters + feature lists per target). Raises with a clear
        message when a target's model artifact is missing — the inference
        path requires a prior training run in the same work dir."""
        from otto_tpu.models.gbdt import GBDTRanker

        backend = self.cfg.ranker_backend
        rankers: Dict[str, object] = {}
        for tname in TYPES:
            rpath = self._p(f"ranker-{backend}-{tname}.npz")
            if not os.path.exists(rpath):
                raise FileNotFoundError(
                    f"no trained {backend} ranker for '{tname}' at {rpath}; "
                    "run the pipeline with labels first to train rankers"
                )
            rankers[tname] = (
                GBDTRanker.load(rpath)
                if backend == "gbdt"
                else Ranker.load(rpath, self.cfg.ranker)
            )
        return rankers

    def build_retriever(self, train: Events, test: Events) -> "Retriever":
        """Stages C7-C12: co-vis counts, embeddings, kNN, clusters,
        popularity — everything retrieval needs, artifact-cached."""
        t0 = time.time()
        cfg = self.cfg
        full = train.concat(test)

        # ---- C7 co-visitation --------------------------------------------
        if self._cached("covis.pkl"):
            with open(self._p("covis.pkl"), "rb") as fh:
                covis_tables = pickle.load(fh)
        else:
            if self.mesh is not None and self.mesh.n_data > 1:
                from otto_tpu.engine.covis import ShardedCoVisCounter

                counter = ShardedCoVisCounter(cfg.covis, self.mesh)
            else:
                counter = CoVisCounter(cfg.covis)
            counter.update(train)
            counter.update(test)
            covis_tables = {
                k: tuple(np.asarray(x) for x in v)
                for k, v in counter.retrieval_tables(self.n_aids).items()
            }
            with open(self._p("covis.pkl"), "wb") as fh:
                pickle.dump(covis_tables, fh)
        self._log("covis", t0)

        # ---- C8 w2vec + C9 kNN -------------------------------------------
        models: Dict[str, Word2Vec] = {}
        knns = {}
        for name, wcfg in cfg.w2vec.items():
            mpath = self._p(f"w2v-{name}.npz")
            if self._cached(f"w2v-{name}.npz"):
                models[name] = Word2Vec.load(mpath, wcfg)
            else:
                if wcfg.sampler == "device":
                    # row-sharded tables when the mesh has a model axis
                    # (SURVEY §2.2's one genuine model-parallel axis).
                    # Per-epoch checkpoint: a crash mid-training then
                    # costs one epoch, not the whole model.
                    ckpt = self._p(f"w2v-{name}.ckpt") if self.use_cache else None
                    models[name] = train_word2vec_device(
                        full, wcfg, self.n_aids, mesh_ctx=self.mesh,
                        checkpoint_path=ckpt,
                    )
                else:
                    ckpt = None
                    models[name] = train_word2vec(full, wcfg, self.n_aids)
                models[name].save(mpath)
                # only after the .npz artifact is safely written does the
                # epoch checkpoint become redundant — removing it first left
                # a crash window with NEITHER artifact
                if ckpt and os.path.exists(ckpt):
                    os.remove(ckpt)
            kpath = self._p(f"knn-{name}.npz")
            if self._cached(f"knn-{name}.npz"):
                z = np.load(kpath)
                knns[name] = (z["neighbor"], z["dist"])
            else:
                kt = build_knn_tables(
                    models[name], self.n_aids, mesh_ctx=self.mesh
                )
                np.savez_compressed(kpath, neighbor=kt.neighbor, dist=kt.dist)
                knns[name] = (kt.neighbor, kt.dist)
            self._log(f"w2vec {name}", t0)

        # w2vec quality diagnostic: neighbour overlap vs co-count neighbours
        # (the reference's label-free embedding-quality instrument,
        # model/w2vec_aids.py:246-336) — logged + persisted per model
        from otto_tpu.eval.diagnostics import (
            w2vec_covis_overlap,
            write_overlap_report,
        )

        co_nbr = covis_tables["click_to_click"][0]
        for name in cfg.w2vec:
            stats = w2vec_covis_overlap(knns[name][0], co_nbr)
            log.info("w2vec overlap %s: %s", name, stats)
            write_overlap_report(
                self._p(f"stats_w2vec_x_co_click-{name}.csv"), stats
            )

        # ---- C10 session embeddings --------------------------------------
        main_model = models[next(iter(cfg.w2vec))]
        aid_emb = main_model.embedding_by_aid(self.n_aids)
        if self._cached("session_emb.npz"):
            z = np.load(self._p("session_emb.npz"))
            sess_ids, sess_emb = z["session"], z["emb"]
        else:
            tp = time.time()
            packed = pack_sessions(full)
            log.info("session_emb: pack_sessions %.1fs", time.time() - tp)
            sess_ids, sess_emb = compute_session_embeddings(
                packed, aid_emb, mesh_ctx=self.mesh
            )
            del packed
            # uncompressed: zlib over the [12.9M, D] f32 grid (~5 GB) costs
            # minutes on the 2-core host vs seconds of raw disk write
            np.savez(
                self._p("session_emb.npz"), session=sess_ids, emb=sess_emb
            )
        self._log("session_emb", t0)

        # ---- C11 kmeans ---------------------------------------------------
        n_clusters = cfg.kmeans.n_clusters_to_find[0]
        if self._cached("clusters.npz"):
            z = np.load(self._p("clusters.npz"))
            cl_labels = z["cluster"]
        else:
            if self.mesh is not None and self.mesh.n_data > 1:
                from otto_tpu.ops.kmeans import kmeans_fit_dp

                _, cl_labels, inertia, n_iter = kmeans_fit_dp(
                    sess_emb,
                    n_clusters,
                    self.mesh.mesh,
                    axis=self.mesh.data_axis,
                    max_iter=cfg.kmeans.max_iter,
                    tol=cfg.kmeans.tol,
                    seed=cfg.kmeans.seed,
                )
            else:
                _, cl_labels, inertia, n_iter = kmeans_fit(
                    sess_emb,
                    n_clusters,
                    max_iter=cfg.kmeans.max_iter,
                    tol=cfg.kmeans.tol,
                    seed=cfg.kmeans.seed,
                )
            np.savez_compressed(
                self._p("clusters.npz"), session=sess_ids, cluster=cl_labels
            )
            log.info("kmeans inertia=%.1f iters=%d", inertia, n_iter)
            # inertia log CSV (reference: model/kmeans_sessions.py:163-165)
            with open(self._p("kmeans-inertia.csv"), "a") as fh:
                if fh.tell() == 0:
                    fh.write("n_clusters,inertia,n_iter,n_points\n")
                fh.write(
                    f"{n_clusters},{inertia:.3f},{n_iter},{len(cl_labels)}\n"
                )
        self._log("kmeans", t0)

        # ---- C12 popularity ----------------------------------------------
        # vectorized session->cluster join (a python dict loop over the
        # event table costs tens of seconds at 10^7 events on the 2-core
        # host); sess_ids is sorted by construction
        cl_arr = np.asarray(cl_labels, np.int32)
        pos = np.searchsorted(sess_ids, full.session)
        pos_c = np.clip(pos, 0, len(sess_ids) - 1)
        hit = sess_ids[pos_c] == full.session
        ev_cluster = np.where(hit, cl_arr[pos_c], 0).astype(np.int32)
        pop50 = compute_popularity(
            full, ev_cluster, n_clusters, self.n_aids, cfg.popularity,
            mesh_ctx=self.mesh,
        )
        pop1 = compute_popularity(
            full,
            np.zeros(len(full), np.int32),
            1,
            self.n_aids,
            cfg.popularity,
            mesh_ctx=self.mesh,
        )
        self._log("popularity", t0)

        # ---- C13 retrieval -----------------------------------------------
        from otto_tpu.engine.covis import CoVisTables

        ctx = RetrievalContext(
            covis=tuple(
                CoVisTables(*(jnp.asarray(a) for a in covis_tables[n]))
                for n in cfg.covis.names
            ),
            knn_all=tuple(jnp.asarray(a) for a in knns[list(cfg.w2vec)[0]]),
            knn_1_2=tuple(jnp.asarray(a) for a in knns[list(cfg.w2vec)[1]]),
            pop_cl50_cand=jnp.asarray(pop50.candidate),
            pop_cl50_ranks=jnp.asarray(pop50.ranks),
            pop_cl1_rank=jnp.asarray(pop1.aid_rank),
            aid_emb=jnp.asarray(aid_emb),
        )
        from otto_tpu.engine.retrieval import SessionLookup

        retriever = Retriever(
            ctx=ctx,
            cfg=cfg.retrieval,
            sessions=SessionLookup.build(sess_ids, cl_labels, sess_emb),
            mesh=self.mesh,
        )
        self._log("context built", t0)
        return retriever

    def retrieve_with_features(
        self,
        train: Events,
        test: Events,
        labels: Optional[Labels] = None,
        batch_sessions: int = 256,
    ):
        """Stages C7-C14: stats/embeddings/clusters/popularity -> fused
        retrieval + features -> retrieval-ceiling eval. Returns
        (batches, targets, metrics); targets is None without labels.

        Keeps every batch's [S, C, F] feature tensor device-resident at
        once — use run_streaming for test sets past ~50k sessions."""
        t0 = time.time()
        retriever = self.build_retriever(train, test)
        batches = retriever.run(test, batch_sessions=batch_sessions)
        self._log("retrieve", t0, f"{sum(b.cand.shape[0] for b in batches)} sessions")

        targets = None
        metrics: Dict[str, float] = {}
        if labels is not None:
            targets = join_labels(batches, labels)
            metrics = self._eval_retrieved(
                np.concatenate([b.session for b in batches]),
                np.concatenate([b.cand for b in batches]),
                batches, labels, t0,
            )
        return batches, targets, metrics

    def _eval_retrieved(self, all_sess, all_cand, src_batches, labels, t0):
        """C14: retrieval-ceiling eval + per-source recall report.
        src_batches may hold RetrievedBatch or SrcFlagBatch objects."""
        metrics: Dict[str, float] = {}
        ceiling = recall_at_k(all_sess, all_cand, labels, cutoffs=(20, 100, 200))
        with open(self._p("eval_retrieved.json"), "w") as fh:
            json.dump(ceiling, fh, indent=2)
        for t in ("clicks", "carts", "orders", "total"):
            metrics[f"ceiling_{t}"] = ceiling[t]["topall"]
        self._log("eval_retrieved", t0, json.dumps(ceiling["total"]))

        # per-source recall table (C14 full report,
        # reference: model/eval_retrieved.py:37-139)
        from otto_tpu.eval.per_source import (
            eval_retrieved_by_source,
            format_report,
        )

        per_src = eval_retrieved_by_source(src_batches, labels)
        with open(self._p("eval_retrieved_sources.json"), "w") as fh:
            json.dump(per_src, fh, indent=2)
        log.info("per-source recall:\n%s", format_report(per_src))
        # own stage row: at reference scale this host path costs ~33 min
        # and previously hid inside the next stage's delta
        self._log("eval per-source", t0)
        return metrics

    def rank_and_eval(
        self,
        batches,
        targets,
        labels: Labels,
        metrics: Optional[Dict[str, float]] = None,
    ) -> Dict[str, float]:
        """Stages C15-C19: downsample -> train rankers -> score/top-20 ->
        submission -> recall eval. Mutates and returns `metrics`."""
        t0 = time.time()
        cfg = self.cfg
        if metrics is None:
            metrics = {}

        # ---- C15/C16 downsample + train rankers --------------------------
        rankers: Dict[str, object] = {}
        for tname in TYPES:
            rankers[tname] = self._train_ranker_cached(
                tname,
                lambda tname=tname: rank_engine.downsample(
                    batches, targets, TYPE2ID[tname], cfg.ranker
                ),
                t0,
            )

        # ---- C17/C18 rank + submit -----------------------------------
        preds = {}
        for tname in TYPES:
            s, a, _ = rank_engine.score_and_topk(batches, rankers[tname])
            preds[tname] = (s, a)
        return self._submit_and_eval(preds, labels, metrics, t0)

    def _train_ranker_cached(self, tname: str, rows_fn, t0: float):
        """C15/C16 for one target type: artifact cache -> downsampled rows
        via rows_fn() -> session-level 75/25 train/valid split -> train."""
        from otto_tpu.models.gbdt import GBDTRanker, train_gbdt_ranker

        cfg = self.cfg
        backend = cfg.ranker_backend
        rname = f"ranker-{backend}-{tname}.npz"
        rpath = self._p(rname)
        if self._cached(rname):
            return (
                GBDTRanker.load(rpath)
                if backend == "gbdt"
                else Ranker.load(rpath, cfg.ranker)
            )
        feats, y, sess = rows_fn()
        # session-level 75/25 train/valid split for ndcg reporting
        # (reference: model/train_lgbm_rankers.py:184-204 file split)
        u_sess = np.unique(sess)
        n_train = max(1, int(len(u_sess) * 0.75))
        valid_set = None
        if len(u_sess) - n_train >= 8:
            vmask = np.isin(sess, u_sess[n_train:])
            valid_set = (feats[vmask], y[vmask], sess[vmask])
            feats, y, sess = feats[~vmask], y[~vmask], sess[~vmask]
        if backend == "gbdt":
            dp = self.mesh is not None and self.mesh.n_data > 1
            ranker = train_gbdt_ranker(
                feats, y, sess, FEATURE_NAMES, cfg.gbdt, valid=valid_set,
                mesh=self.mesh.mesh if dp else None,
                mesh_axis=self.mesh.data_axis if dp else "data",
            )
        else:
            ranker = train_ranker(
                feats.astype(np.float32, copy=False), y, sess, FEATURE_NAMES,
                cfg.ranker, valid=valid_set,
            )
        ranker.save(rpath)
        if backend == "gbdt":
            # feature-importance report (reference persists gain-importance
            # CSVs per model, model/train_lgbm_rankers.py:207-210)
            imp = ranker.feature_importance("gain")
            order = np.argsort(-imp)
            with open(self._p(f"feat-importance-{tname}.csv"), "w") as fh:
                fh.write("feature,gain_importance\n")
                for i in order:
                    fh.write(f"{FEATURE_NAMES[i]},{imp[i]:.6g}\n")
        self._log(f"ranker {tname} ({backend})", t0, f"{len(y)} rows")
        return ranker

    def _submit_and_eval(self, preds, labels, metrics, t0):
        """C18/C19 tail: write the Kaggle CSV, evaluate recall@20, persist
        reports, re-parse cross-check. Without labels only the CSV is
        written (the Kaggle-submission production path)."""
        rank_engine.write_submission(self._p("submission.csv"), preds)
        self._log("submit", t0)
        if labels is None:
            return metrics

        res = evaluate_topk(preds, labels)
        metrics.update(res)
        with open(self._p("eval_submission.json"), "w") as fh:
            json.dump(res, fh, indent=2)
        # timestamped + git-hashed report copy (reference: utils.py:56-74)
        from otto_tpu.utils.reports import report_name

        with open(self._p(report_name("eval-submission") + ".json"), "w") as fh:
            json.dump(res, fh, indent=2)
        self._log("eval", t0, json.dumps(res))

        # cross-check via independent re-parse of the written CSV (the
        # organizer-scorer role, reference: model/eval_submission_otto.sh)
        from otto_tpu.eval.recall import evaluate_submission_file

        res2 = evaluate_submission_file(self._p("submission.csv"), labels)
        if abs(res2["total"] - res["total"]) > 1e-9:
            log.warning(
                "submission re-parse mismatch: %.6f vs %.6f",
                res2["total"], res["total"],
            )

        return metrics


def run_synthetic(
    cfg: Config,
    work_dir: str,
    spec: SyntheticSpec,
    batch_sessions: int = 256,
    streaming: Optional[bool] = None,
    mesh: "Optional[object]" = None,
) -> Dict[str, float]:
    """Generate synthetic data, split, and run the full pipeline.
    streaming=None auto-selects the streaming runner past 50k test
    sessions (the batch runner pins every feature tensor on device)."""
    ev = generate(spec)
    sp = split_events(ev, cfg.data.test_days, cfg.data.seed)
    pipe = Pipeline(cfg=cfg, work_dir=work_dir, n_aids=spec.n_aids, mesh=mesh)
    if streaming is None:
        streaming = len(np.unique(sp.test.session)) > 50_000
    if streaming:
        return pipe.run_streaming(
            sp.train, sp.test, sp.labels, batch_sessions=batch_sessions
        )
    return pipe.run(sp.train, sp.test, sp.labels, batch_sessions=batch_sessions)
