"""More than one device and more than one process.

Port of lepton_tpu/parallel/: mesh.py (a ('data', 'seg') grid of a
process's devices: many images over its rows, one image's segments or one
.lep's lanes over its columns) and multihost.py (a cooperative encode of
one JPEG by several processes over torch.distributed).  Segments are
independent streams, so no collective runs on the hot path: only finished
byte streams cross between devices and processes.
"""
