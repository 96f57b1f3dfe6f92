"""The port's whole decode slice on the CPU against the JAX package, on
every case of tests/test_torch_encode.py (4:4:4, 4:2:2, grey, odd sizes,
restart markers, optimized Huffman tables, four segments).

decompress_device with device="cpu" runs the plain PyTorch version of the
decode kernel; it must give back the original JPEG bytes, as
lepton_tpu.api.decompress_tpu does, on .lep files written by the JAX
package's compress and by the port's compress_device.  Each
decompress_tpu compiles once per geometry (several seconds here), so the
cases have a file of their own.
"""
import pytest

jax = pytest.importorskip("jax")

import lepton_tpu.api as japi  # noqa: E402
from lepton_tpu_torch import api  # noqa: E402
from test_torch_encode import CASES, _jpeg, _port_with_segments  # noqa: E402


@pytest.mark.parametrize("name,w,h,mode,kw,k", CASES,
                         ids=[c[0] for c in CASES])
def test_decompress_device_matches(name, w, h, mode, kw, k):
    """The original JPEG back from the JAX package's .lep and from the
    port's, as decompress_tpu gives it."""
    data = _jpeg(w, h, seed=len(name), mode=mode, **kw)
    lep = japi.compress(data, max_threads=k, min_threads=k)
    port_lep = _port_with_segments(data, k)
    assert api.decompress_device(lep, device="cpu") == data
    if port_lep != lep:
        assert api.decompress_device(port_lep, device="cpu") == data
    assert japi.decompress_tpu(lep) == data
