"""Operator matrices of quimb_torch."""
