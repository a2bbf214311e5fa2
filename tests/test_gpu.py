"""Device suite: every engine x storage row of ``bench.ROWS`` on the GPU, at
the timed sizes (64 channels, 10 s IR = 938 partitions, block 512), against
the exact-f64 oracle at its storage's SNR class (``bench._SNR_CLASS_DB``).

Marked ``gpu``: skips without a GPU. ``python chip_smoke.py`` runs it on
the card (``NEOJAX_GPU_TESTS=1 pytest -m gpu``).
"""

import sys

import numpy as np
import pytest

sys.path.insert(0, ".")
import bench  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def oracle():
    bench._setup_jax()
    return bench._oracle_head()


@pytest.mark.parametrize("name", list(bench.ROWS))
def test_row_meets_snr_class(name, oracle):
    storage = bench.ROWS[name][1]
    eng = bench.make_row_engine(name)
    sig = bench._signal(bench.row_stream_blocks())
    snr = bench._snr_db(bench.snr_window(eng.process(sig)), oracle)
    assert snr >= bench._SNR_CLASS_DB[storage], (name, snr)


def test_fft_auto_backend_matches_numpy():
    """``fft.rfft`` with the "auto" backend (jnp.fft, cuFFT on the card)
    agrees with numpy at the block transform size."""
    import jax.numpy as jnp

    from neojax import fft

    x = np.random.default_rng(0).uniform(-1, 1, (64, 1024)).astype(np.float32)
    got = np.asarray(fft.rfft(jnp.asarray(x)))
    ref = np.fft.rfft(x.astype(np.float64))
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-5
