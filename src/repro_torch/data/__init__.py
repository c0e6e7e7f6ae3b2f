"""Synthetic data for the port (numpy, deterministic by seed)."""
