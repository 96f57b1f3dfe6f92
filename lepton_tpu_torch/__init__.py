"""lepton_tpu_torch: the PyTorch/CUDA port of lepton_tpu.

Entry points: the device codec lepton_tpu_torch.api (compress_device,
batch_compress_device, decompress_device, batch_decompress_device: modes Z
and X, 1 to 4 components, containers v1 to v3, on one CUDA card); the host
codec lepton_tpu_torch.host (compress, decompress, generic_compress,
compress_any, decompress_all, re-exported by api), which needs no torch;
the CLI (python -m lepton_tpu_torch, cli.py: on the card unless
-device=host) and the batch socket server (serve.py).  The package imports torch and numpy, never JAX and
nothing of lepton_tpu: it keeps its own copies of the host layers.
"""

__version__ = "0.1.0"
