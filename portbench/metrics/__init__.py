"""Readers of the metrics, one file per metric; files starting with an
underscore are helpers."""
