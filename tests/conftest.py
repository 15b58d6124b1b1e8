"""Test env: an 8-virtual-device CPU platform, so every sharded code path
(mesh creation, shard_map collectives, pjit shardings) is exercised without
accelerator hardware (SURVEY.md §4 'Implication for the new framework').

The one exception is a run started with JAX_PLATFORMS=cuda on a machine
with a card: the `gpu`-marked tests then run there (README "Tests"); every
other run is pinned to the CPU, whatever the environment says."""
import os

import pytest

_ON_CARD = os.environ.get("JAX_PLATFORMS") == "cuda"
if not _ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where there is none. Decided
    here, at run time, so every xdist worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA device (found {dev.platform})")
    return dev
