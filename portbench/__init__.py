"""The benchmark of quimb_torch on one NVIDIA H100; see README.md."""
