"""The port on a CUDA card: the coder kernel against its plain version, and
the whole encode on cuda against the same encode on the CPU.

This file imports no JAX, so it runs where only torch is installed:

    python -m pytest tests/test_torch_cuda.py -q

Without a card every test skips.  Streams are compared byte for byte: the
tolerance is zero.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from lepton_tpu_torch import api
from lepton_tpu_torch.kernels import vpx_coder
from lepton_tpu_torch.model.tables import ARENA_SIZE, arena_from_template


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _streams(idxs, bits, template, device):
    out, nb = vpx_coder.encode_streams(
        torch.as_tensor(idxs, device=device),
        torch.as_tensor(bits, device=device),
        None if template is None else template.to(device))
    return vpx_coder.finalize(out, nb)


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["identity", "template"])
def test_kernel_matches_plain(cuda, start):
    """Branch reuse and a 1500-symbol carry chain, from the identity arena
    and from a random trained template."""
    template = None
    if start == "template":
        raw = np.random.default_rng(42).integers(0, 256, (ARENA_SIZE, 3),
                                                 dtype=np.uint8)
        raw[:, 2] = 1 + raw[:, 2] % 254
        template = arena_from_template(api.pack_model(raw))
    idxs, bits = vpx_coder.build_symbol_streams(
        chip_smoke.adversarial_segments())
    before = vpx_coder.encode_streams.launches
    assert (_streams(idxs, bits, template, cuda)
            == _streams(idxs, bits, template, "cpu"))
    assert vpx_coder.encode_streams.launches > before


@pytest.mark.cuda
def test_compress_device_cuda_equals_cpu(cuda):
    data = chip_smoke.make_photo(3, 96, 64)
    assert api.compress_device(data, num_segments=4) \
        == api.compress_device(data, num_segments=4, device="cpu")
