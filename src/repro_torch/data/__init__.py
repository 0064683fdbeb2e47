"""Synthetic data, replayable by (seed, step): a copy of ``repro.data``."""
