"""Iterative linear algebra of quimb_torch."""
