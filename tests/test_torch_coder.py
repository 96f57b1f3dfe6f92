"""Port VPX coder (lepton_tpu_torch.kernels.vpx_coder) against the JAX package.

The plain version runs here on the CPU; the CUDA kernel is held against it
in tests/test_torch_cuda.py, which imports no JAX so that it runs on a
machine with the card.  Streams are compared byte for byte: the tolerance
is zero.
"""
import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lepton_tpu.api import _model_template_packed  # noqa: E402
from lepton_tpu.coder.vpx import BoolWriter  # noqa: E402
from lepton_tpu.kernels import pallas_coder, vpx_scan  # noqa: E402
from lepton_tpu_torch.kernels import branch_probs, vpx_coder  # noqa: E402
from lepton_tpu_torch.model.branch import update_branch  # noqa: E402
from lepton_tpu_torch.model.tables import (ARENA_SIZE,  # noqa: E402
                                           arena_from_template)


def _scalar_encode(idx, bits):
    state = {}
    w = BoolWriter()
    for i, b in zip(idx, bits):
        fc, tc, prob = state.get(i, (1, 1, 128))
        w.put_bit(int(b), prob)
        state[i] = update_branch(fc, tc, prob, bool(b))
    return w.finish()


def _reuse_streams():
    """Random branches with 70% reuse (tests/test_pallas_coder.py)."""
    rng = random.Random(9)
    segments = []
    for s in range(2):
        n = 900 - 100 * s
        idx = [rng.randrange(ARENA_SIZE) for _ in range(n)]
        for k in range(1, n):
            if rng.random() < 0.7:
                idx[k] = idx[rng.randrange(k)]
        bit = [rng.randrange(2) for _ in range(n)]
        segments.append((np.asarray(idx, np.int32), np.asarray(bit, np.uint8)))
    return segments


def _carry_stream():
    """1500 symbols hammering one branch, then random ones: long carries."""
    rng = random.Random(4)
    idx = [7] * 1500
    bit = [1] * 1500
    for _ in range(64):
        idx.append(rng.randrange(ARENA_SIZE))
        bit.append(rng.randrange(2))
    return [(np.asarray(idx, np.int32), np.asarray(bit, np.uint8))]


def _port(idxs, bits, template=None, device="cpu"):
    out, nb = vpx_coder.encode_streams(
        torch.as_tensor(idxs, device=device),
        torch.as_tensor(bits, device=device),
        None if template is None else template.to(device))
    return vpx_coder.finalize(out, nb)


@pytest.mark.parametrize("make", [_reuse_streams, _carry_stream],
                         ids=["reuse", "carry_chain"])
def test_plain_coder_matches_pallas_kernel(make):
    segments = make()
    idxs, bits = vpx_coder.build_symbol_streams(segments)
    jidx, jbit = vpx_scan.build_symbol_streams(segments)
    assert np.array_equal(idxs, jidx) and np.array_equal(bits, jbit)
    out, nb = pallas_coder.encode_streams_pallas(jidx, jbit, interpret=True)
    ref = pallas_coder.finalize(out, nb)
    port = _port(idxs, bits)
    assert port == ref
    assert port == [_scalar_encode(i.tolist(), b.tolist())
                    for i, b in segments]


def test_template_arena_matches_jax_twopass(synth_model, monkeypatch):
    """arena_from_template + the plain coder == the JAX sorted two-pass
    coder started from the same trained template."""
    monkeypatch.setenv("LEPTON_COMPRESSION_MODEL", synth_model)
    packed = _model_template_packed()
    segments = _reuse_streams() + _carry_stream()
    idxs, bits = vpx_coder.build_symbol_streams(segments)
    emit, byte, carry, nbytes = [np.asarray(x) for x in
                                 vpx_scan.encode_streams_twopass(
                                     jnp.asarray(idxs), jnp.asarray(bits),
                                     template=jnp.asarray(packed,
                                                          jnp.uint32))]
    ref = vpx_scan.finalize_streams(emit, byte, carry, nbytes)
    assert _port(idxs, bits, arena_from_template(packed)) == ref
    # the template must matter: the identity start gives other bytes
    assert _port(idxs, bits) != ref


def test_arena_from_template_layout():
    packed = np.zeros(ARENA_SIZE, np.uint32)
    packed[5] = (3 << 16) | (200 << 8) | 17      # c0=3, c1=200, prob=17
    arena = arena_from_template(packed)
    assert arena.dtype == torch.int32 and arena.shape == (ARENA_SIZE,)
    assert int(arena[5]) == 3 | (200 << 8) | (17 << 16)
    assert int(arena[0]) == 0


def test_branch_update_full_domain():
    """The vectorized update equals update_branch on every (fc, tc, bit),
    prob wrapped to 8 bits as the host stores it."""
    fc, tc, obs = np.meshgrid(np.arange(256), np.arange(256), [0, 1],
                              indexing="ij")
    got = branch_probs.branch_update(torch.as_tensor(fc.ravel()),
                                     torch.as_tensor(tc.ravel()),
                                     torch.as_tensor(obs.ravel() != 0)).numpy()
    want = np.array([
        (lambda r: r[0] | (r[1] << 8) | ((r[2] & 0xFF) << 16))(
            update_branch(int(f), int(t), 0, bool(o)))
        for f, t, o in zip(fc.ravel(), tc.ravel(), obs.ravel())])
    assert np.array_equal(got, want)


def test_encode_streams_rejects_bad_inputs():
    idx = torch.zeros((2, 4), dtype=torch.int64)
    bit = torch.zeros((2, 4), dtype=torch.uint8)
    with pytest.raises(TypeError):
        vpx_coder.encode_streams(idx, bit)
    with pytest.raises(ValueError):
        vpx_coder.encode_streams(idx.int(), bit[:, :3])
    for bad in (ARENA_SIZE, vpx_coder.FIXED_PROB - 1):
        with pytest.raises(ValueError, match="idx must lie"):
            vpx_coder.encode_streams(torch.full((2, 4), bad,
                                                dtype=torch.int32), bit)

