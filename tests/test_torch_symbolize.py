"""Port symbolize_slice (lepton_tpu_torch.kernels.symbolize) against JAX.

Random planes with realistic sparsity, luma and chroma models, segment-top
rows masked in row_has_above, and an early-EOF size_limit cut.  Each
block's live (branch, bit) slots, in slab order, must be the JAX slab's:
the emission order is the same and the tolerance is zero.  The port's
slab gives each coded value a tenth residual slot, which only an 11-bit
AC coefficient fills (the host codec codes it; the JAX slab has 9), so
PAD sits in other places.
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


def _assert_same_emission(ti, tb, ji, jb):
    """Each block's live slots, in order, equal: idx and bit."""
    tl, jl = ti != PAD, ji != PAD
    assert np.array_equal(tl.sum(-1), jl.sum(-1))
    assert np.array_equal(ti[tl], ji[jl])
    assert np.array_equal(tb[tl], jb[jl])


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
    assert ti.shape == (H, W, tsym.BLOCK_SLOTS)
    assert ti.dtype == np.int32 and tb.dtype == np.uint8
    _assert_same_emission(ti, tb, ji, jb)
    live = ti != PAD
    assert live.sum() > H * W * 20


def test_symbolize_default_rows_and_size_limit():
    """Default row contexts, and blocks past size_limit emit nothing but
    the first block of each row, which the host codec codes before it
    tests the limit (leptonc.c process_row); the JAX slab leaves it out,
    and is held equal on every other block."""
    H, W = 4, 7
    coefs = _plane(7, H, W)
    ti, tb, ji, jb = _run_both(coefs, 0, _qtable(7), None, 3, 3 + 17)
    live = (ti != PAD).reshape(H * W, -1).any(axis=1)
    jlive = (ji != PAD).reshape(H * W, -1).any(axis=1)
    assert jlive[:17].all() and not jlive[17:].any()
    first = np.arange(H * W) % W == 0
    assert np.array_equal(live, jlive | first)
    keep = jlive.reshape(H, W)
    _assert_same_emission(ti[keep], tb[keep], ji[keep], jb[keep])


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
