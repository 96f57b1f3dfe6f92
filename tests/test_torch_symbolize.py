"""Port symbolize_slice (lepton_tpu_torch.kernels.symbolize) against JAX.

Random planes with realistic sparsity, luma and chroma models, segment-top
rows masked in row_has_above, and an early-EOF size_limit cut.  The
(branch, bit) slabs must be equal wherever a slot is live, and PAD in the
same places: the tolerance is zero.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lepton_tpu.kernels import symbolize as jsym  # noqa: E402
from lepton_tpu.model.context import ColorTables as JColorTables  # noqa: E402
from lepton_tpu_torch.kernels import symbolize as tsym  # noqa: E402
from lepton_tpu_torch.kernels.vpx_coder import PAD  # noqa: E402
from lepton_tpu_torch.model.context import ColorTables  # noqa: E402


def _plane(seed, H, W):
    """Coefficients shaped like a JPEG's: large DC, AC decaying with
    frequency, mostly zero at high frequencies, all within 11 bits."""
    rng = np.random.default_rng(seed)
    freq = np.add.outer(np.arange(8), np.arange(8)).reshape(64)
    scale = 60.0 / (1 + freq) ** 1.3
    coefs = np.round(rng.laplace(0, scale, (H, W, 64))).astype(np.int64)
    coefs[rng.random((H, W, 64)) < 0.02 * freq] = 0
    coefs[..., 0] = rng.integers(-1000, 1000, (H, W))
    return np.clip(coefs, -1023, 1023).astype(np.int16)


def _qtable(seed):
    return np.random.default_rng(seed).integers(1, 60, 64)


def _run_both(coefs, ci, q, rha, row_block_offset, size_limit):
    ct, jct = ColorTables(q), JColorTables(q)
    targs = [torch.as_tensor(np.asarray(a, np.int32)) for a in (
        ct.quant, ct.icos_idct_edge_8192_dequantized_x,
        ct.icos_idct_edge_8192_dequantized_y, ct.min_noise_threshold)]
    jargs = [jnp.asarray(np.asarray(a, np.int32)) for a in (
        jct.quant, jct.icos_idct_edge_8192_dequantized_x,
        jct.icos_idct_edge_8192_dequantized_y, jct.min_noise_threshold)]
    ti, tb = tsym.symbolize_slice(
        torch.as_tensor(coefs), ci, *targs, row_block_offset, size_limit,
        None if rha is None else torch.as_tensor(rha))
    ji, jb = jsym.symbolize_slice(
        jnp.asarray(coefs), ci, *jargs, jnp.int32(row_block_offset),
        jnp.int32(size_limit), None if rha is None else jnp.asarray(rha))
    return ti.numpy(), tb.numpy(), np.asarray(ji), np.asarray(jb)


@pytest.mark.parametrize("ci", [0, 1], ids=["luma", "chroma"])
def test_symbolize_matches_jax(ci):
    H, W = 5, 6
    coefs = _plane(ci, H, W)
    rha = np.ones(H, bool)
    rha[[0, 2]] = False                 # row 2 starts a segment
    ti, tb, ji, jb = _run_both(coefs, ci, _qtable(ci), rha, 0, H * W)
    assert ti.shape == (H, W, tsym.BLOCK_SLOTS) == ji.shape
    assert ti.dtype == np.int32 and tb.dtype == np.uint8
    assert np.array_equal(ti, ji)
    live = ti != PAD
    assert live.sum() > H * W * 20
    assert np.array_equal(tb[live], jb[live])


def test_symbolize_default_rows_and_size_limit():
    """Default row contexts, and blocks past size_limit emit nothing."""
    H, W = 4, 7
    coefs = _plane(7, H, W)
    ti, tb, ji, jb = _run_both(coefs, 0, _qtable(7), None, 3, 3 + 17)
    assert np.array_equal(ti, ji)
    live = ti != PAD
    assert np.array_equal(tb[live], jb[live])
    flat = live.reshape(H * W, -1).any(axis=1)
    assert flat[:17].all() and not flat[17:].any()


def test_symbolize_row_chunks_equal_whole_plane():
    """Symbolizing in row chunks with one row of above-context overlap (as
    batch_encode does) gives the whole plane's slab."""
    H, W = 6, 5
    coefs = _plane(11, H, W)
    ct = ColorTables(_qtable(11))
    args = [torch.as_tensor(np.asarray(a, np.int32)) for a in (
        ct.quant, ct.icos_idct_edge_8192_dequantized_x,
        ct.icos_idct_edge_8192_dequantized_y, ct.min_noise_threshold)]
    rha = torch.ones(H, dtype=torch.bool)
    rha[[0, 3]] = False
    whole, _ = tsym.symbolize_slice(torch.as_tensor(coefs), 0, *args, 0,
                                    H * W - 4, rha)
    parts = []
    for r0 in range(0, H, 2):
        lo = max(r0 - 1, 0)
        idx, _ = tsym.symbolize_slice(torch.as_tensor(coefs[lo:r0 + 2]), 0,
                                      *args, lo * W, H * W - 4,
                                      rha[lo:r0 + 2])
        parts.append(idx[r0 - lo:])
    assert torch.equal(torch.cat(parts), whole)
