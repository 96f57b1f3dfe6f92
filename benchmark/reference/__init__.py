"""The plain reference of the benchmark: Lepton's host codec in Python.

The modules below this package are frozen copies of the port's pure-Python
host layers (lepton_tpu_torch/ as of the benchmark's first commit), kept
here so that no later change to the program can change what a run is held
to: constants.py, jpeg/ (parser, image info, bit reader, Huffman tables,
the baseline and progressive scan decoders), model/ (branch counters,
contexts, tables), codec/ (blocks, segment driver), coder/vpx.py (the VPX
bool coder) and container/ (format, handoffs, mux).  They were cut to what
a baseline or progressive JPEG in a version-1 container needs: no native
library, no brotli.  They import numpy and each other, nothing of the program.

encode.py builds the expected .lep of a JPEG from these, as the host
codec's Python route does (host.compress with the C library absent), and
is the one module that callers use.
"""
