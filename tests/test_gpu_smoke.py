"""On-card smoke test: the engine on the GPU, with its Triton kernels,
row-identical to the scalar oracle (skips where JAX has no GPU).

Run on the card with:

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu_smoke.py -q -m gpu -p no:cacheprovider

The same check, at a few hundred reads per engine mode, is phase 3 of
``python chip_smoke.py``.
"""

import os
import sys

import pytest

jax = pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu_devices():
    """The GPU devices, decided when the test runs (never at import:
    pytest-xdist workers must all collect the same tests)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {devs[0].platform!r}")
    return devs[:1]


@pytest.mark.parametrize("mode", sorted(chip_smoke.MODES))
def test_engine_matches_oracle_on_gpu(gpu_devices, mode):
    ids, seqs = chip_smoke.mixed_reads(mode, 48, seed=7)
    want = chip_smoke.oracle_rows(mode, ids, seqs, workers=2)
    engine = chip_smoke.make_engine(mode, gpu_devices)
    got = engine.demux_batch(ids, seqs)
    for rid, g, w in zip(ids, got, want):
        assert g == w, rid
