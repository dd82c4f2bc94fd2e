"""Sampling pipeline."""
