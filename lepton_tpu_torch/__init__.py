"""lepton_tpu_torch: the PyTorch/CUDA port of lepton_tpu's encode path.

Entry points: lepton_tpu_torch.api.compress_device and
batch_compress_device.  The package imports torch and numpy, never JAX and
nothing of lepton_tpu: it keeps its own copies of the host layers.
"""
