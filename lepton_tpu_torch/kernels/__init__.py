"""Device stages of the encode path: phase A, symbolization, lane
assembly and the VPX coder kernel."""
