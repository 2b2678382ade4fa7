"""Synthetic, seekable training data."""
