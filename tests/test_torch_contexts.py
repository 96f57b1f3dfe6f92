"""Port phase A (lepton_tpu_torch.kernels.contexts) against the JAX package.

Random int16 planes that include large magnitudes, with 8- and 16-bit
quantizers, so the int16 and uint16 wraps, the int32 products and the
truncating divides are all reached.  Integer-exact: the tolerance is zero.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lepton_tpu.kernels import contexts as jctx  # noqa: E402
from lepton_tpu.model.context import ColorTables as JColorTables  # noqa: E402
from lepton_tpu_torch.kernels import contexts as tctx  # noqa: E402
from lepton_tpu_torch.model.context import ColorTables  # noqa: E402

KEYS = ("nz7x7", "edges", "pixels", "aavrg", "lak", "dc_pred",
        "uncertainty", "uncertainty2", "cost")


def _plane(seed, H=6, W=7):
    rng = np.random.default_rng(seed)
    small = rng.integers(-40, 41, (H, W, 64))
    large = rng.integers(-32768, 32768, (H, W, 64))
    sparse = rng.random((H, W, 64))
    coefs = np.where(sparse < 0.15, large, np.where(sparse < 0.6, small, 0))
    return coefs.astype(np.int16)


def _tables(seed, qmax):
    rng = np.random.default_rng(seed + 100)
    q = rng.integers(1, qmax + 1, 64)
    return ColorTables(q), JColorTables(q)


def _torch_args(ct):
    return [torch.as_tensor(np.asarray(a, np.int32)) for a in (
        ct.quant, ct.icos_idct_edge_8192_dequantized_x,
        ct.icos_idct_edge_8192_dequantized_y)]


def _jax_args(ct):
    return [jnp.asarray(np.asarray(a, np.int32)) for a in (
        ct.quant, ct.icos_idct_edge_8192_dequantized_x,
        ct.icos_idct_edge_8192_dequantized_y)]


def _assert_same(port, ref):
    for k in KEYS:
        a = port[k].numpy()
        b = np.asarray(ref[k])
        assert a.shape == b.shape, k
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), k


@pytest.mark.parametrize("seed,qmax", [(0, 255), (1, 65535), (2, 8)])
def test_phase_a_matches_jax_reference(seed, qmax):
    """Default row contexts: against both JAX compositions."""
    coefs = _plane(seed)
    ct, jct = _tables(seed, qmax)
    port = tctx.phase_a(torch.as_tensor(coefs), *_torch_args(ct))
    _assert_same(port, jctx.phase_a_reference(jnp.asarray(coefs),
                                              *_jax_args(jct)))
    _assert_same(port, jctx.phase_a(jnp.asarray(coefs), *_jax_args(jct)))


@pytest.mark.parametrize("seed,qmax", [(3, 255), (4, 65535)])
def test_phase_a_masked_rows_match_jax(seed, qmax):
    """Segment-top rows (row_has_above False) drop the above-context."""
    coefs = _plane(seed, H=9, W=5)
    ct, jct = _tables(seed, qmax)
    rha = np.ones(9, bool)
    rha[[0, 3, 4, 8]] = False
    port = tctx.phase_a(torch.as_tensor(coefs), *_torch_args(ct),
                        row_has_above=torch.as_tensor(rha))
    ref = jctx.phase_a(jnp.asarray(coefs), *_jax_args(jct),
                       jnp.asarray(rha))
    _assert_same(port, ref)


def test_bit_length_exact():
    v = np.array([0, 1, 2, 3, 255, 256, 1023, 1024, (1 << 24) - 1, 1 << 24,
                  (1 << 24) + 1, (1 << 31) - 1, -1, -(1 << 31)], np.int32)
    want = [int(x).bit_length() if x > 0 else 0 for x in v.tolist()]
    assert tctx.bit_length(torch.as_tensor(v)).tolist() == want


def _clz_edges():
    """0, 1, 2^k - 1, 2^k and 2^k + 1 up to 2^31 - 1, and negatives down
    to -2^31."""
    v = {0, 1, (1 << 31) - 1}
    for k in range(1, 31):
        v.update({(1 << k) - 1, 1 << k, (1 << k) + 1})
    v.update(-x for x in list(v) if x)
    v.add(-(1 << 31))
    return np.array(sorted(v), np.int32)


def test_bit_length_matches_clz():
    """contexts.bit_length (frexp of the float64 value) against the JAX
    kernels' form, jnp.where(v > 0, 32 - lax.clz(v), 0)
    (lepton_tpu/kernels/contexts.py:253, symbolize.py:58), at every power
    of two's edges and on negatives (0 in both)."""
    v = _clz_edges()
    want = np.asarray(jnp.where(jnp.asarray(v) > 0,
                                32 - jax.lax.clz(jnp.asarray(v)), 0))
    got = tctx.bit_length(torch.as_tensor(v)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want), v[got != want]
