"""Datasets: synthetic triplets for runs without the SynthRAD data."""
