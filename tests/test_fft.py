"""FFT family parity tests.

Oracles follow the reference's strategy (SURVEY.md section 4): round-trips,
cross-implementation checks against numpy and the naive DFT, both backends.
"""

import numpy as np
import pytest

import neojax
from neojax import fft as nfft
from neojax.ops import allclose


ORDERS = range(2, 13)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_fft_roundtrip(make_noise, order, backend):
    n = 2**order
    x = make_noise(n) + 1j * make_noise(n)
    x = x.astype(np.complex64)
    out = nfft.ifft(nfft.fft(x, backend=backend), backend=backend)
    assert allclose(out, x, 1e-4 if n >= 2048 else 1e-5)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_fft_vs_numpy(make_noise, order, backend):
    n = 2**order
    x = (make_noise(n) + 1j * make_noise(n)).astype(np.complex64)
    ref = np.fft.fft(x)
    out = nfft.fft(x, backend=backend)
    # Forward-FFT absolute error grows like the output magnitude: bins are
    # sums of n unit-magnitude terms, so |X| ~ sqrt(n) for noise input and
    # f32 rounding gives ~sqrt(n) * eps_f32-scale absolute error. Bound:
    # sqrt(n) * 1e-5 (the reference's f32 allclose unit, allclose.hpp:36)
    # + 1e-4 floor for the tiny-n regime.
    assert np.max(np.abs(np.asarray(out) - ref)) < np.sqrt(n) * 1e-5 + 1e-4


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_rfft_roundtrip(make_noise, order, backend):
    n = 2**order
    x = make_noise(n)
    spec = nfft.rfft(x, backend=backend)
    assert spec.shape == (n // 2 + 1,)
    out = nfft.irfft(spec, n=n, backend=backend)
    assert allclose(out, x, 1e-4 if n >= 2048 else 1e-5)


@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_rfft_vs_numpy(make_noise, backend):
    x = make_noise(512)
    ref = np.fft.rfft(x)
    out = np.asarray(nfft.rfft(x, backend=backend))
    assert np.max(np.abs(out - ref)) < 1e-3


@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_fft_norms_match_numpy(make_noise, norm):
    x = (make_noise(256) + 1j * make_noise(256)).astype(np.complex64)
    assert allclose(nfft.fft(x, norm=norm), np.fft.fft(x, norm=norm), 1e-4)
    assert allclose(nfft.ifft(x, norm=norm), np.fft.ifft(x, norm=norm), 1e-4)


def test_batched_rfft(make_noise):
    x = make_noise(4, 256)
    out = np.asarray(nfft.rfft(x, backend="matmul"))
    ref = np.fft.rfft(x, axis=-1)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) < 1e-3


@pytest.mark.parametrize("n", [4, 5, 12, 31, 100, 257])
def test_bluestein_dft_arbitrary_sizes(make_noise, n):
    x = (make_noise(n) + 1j * make_noise(n)).astype(np.complex64)
    fwd = np.asarray(nfft.dft(x, forward=True))
    ref = np.fft.fft(x)
    assert np.max(np.abs(fwd - ref)) < 1e-3

    # Unnormalized backward like the reference plan: ifft * n == identity
    bwd = np.asarray(nfft.dft(fwd, forward=False)) / n
    assert np.max(np.abs(bwd - x)) < 1e-3


@pytest.mark.parametrize("n", [4, 16, 64])
def test_naive_dft_oracle(make_noise, n):
    x = (make_noise(n) + 1j * make_noise(n)).astype(np.complex64)
    assert allclose(nfft.naive_dft(x), np.fft.fft(x), 1e-3)


@pytest.mark.parametrize("n", [8, 64, 256])
def test_dct2(make_noise, n):
    from scipy_free_dct import dct2_ref

    x = make_noise(n)
    out = np.asarray(nfft.dct2(x))
    ref = dct2_ref(x)
    assert np.max(np.abs(out - ref)) < 1e-3


def test_rfftfreq():
    assert allclose(nfft.rfftfreq(8, d=1.0), np.fft.rfftfreq(8, d=1.0), 1e-6)
    assert allclose(nfft.rfftfreq(1024, d=1 / 48000), np.fft.rfftfreq(1024, d=1 / 48000), 1e-2)


# --- in-trace DFT-matrix generation (large sizes; avoids giant HLO literals) ---


@pytest.mark.parametrize("n", [4096, 8192])
def test_traced_dft_matrices_match_host_literals(n):
    """Above the literal-size cap, matrices built in-trace (quadrant-exact
    angle reduction) must match the host float64-built literals to ~1 ulp."""
    import jax

    from neojax.fft import matmul_backend as mb

    for traced, host in [
        (jax.jit(lambda: mb.fft_matrices(n))(), mb._fft_mats_np(n)),
        (jax.jit(lambda: mb.rfft_matrices(n))(), mb._rfft_mats_np(n)),
        (jax.jit(lambda: mb.irfft_matrices(n))(), mb._irfft_mats_np(n)),
    ]:
        for got, want in zip(traced, host):
            assert np.max(np.abs(np.asarray(got) - want)) < 3e-7


def test_matmul_backend_large_c2c_under_jit(make_noise):
    """fft backend='matmul' at n=8192 runs under jit with its matrices built
    in-trace (host-built ones would embed ~270 MB of HLO literals)."""
    import jax

    from neojax import fft as nfft

    n = 8192
    x = make_noise(n) + 1j * make_noise(n)
    got = jax.jit(lambda x: nfft.fft(x, backend="matmul"))(x)
    want = np.fft.fft(np.asarray(x))
    assert np.max(np.abs(np.asarray(got) - want)) < 2e-2 * np.max(np.abs(want))
