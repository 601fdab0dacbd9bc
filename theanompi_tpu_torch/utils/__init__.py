"""Optimizers, recorder, tree helpers."""
