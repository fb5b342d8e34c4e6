"""Deterministic synthetic training data (``synthetic.batches_for``)."""
