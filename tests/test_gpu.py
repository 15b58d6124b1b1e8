"""Kernel checks that only mean something on a CUDA device: full-f32 kNN
scores, the retrieval transport and GBDT scoring as the GPU compiler
builds them. Each skips without a card (the `gpu_device` fixture); on one:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

chip_smoke.py's kernel phase runs the same checks at the pipeline's real
widths."""
import numpy as np
import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


def test_knn_l2_matches_float64(gpu_device):
    cs.knn_phase(np.random.default_rng(0), n_corpus=200_000, block=4096,
                 n_check=128, stage_queries=4096)


def test_retrieval_transport_exact(gpu_device):
    cs.transport_phase(np.random.default_rng(1), S=2048, C=512)


def test_gbdt_scoring_matches_numpy(gpu_device):
    cs.gbdt_phase(np.random.default_rng(2), rows=1 << 14)
