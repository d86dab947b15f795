"""Decoding and parameter conversion utilities."""
