"""Kernels, decompositions and host/device transfers of quimb_torch."""
