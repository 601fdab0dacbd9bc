"""Data parallelism: exchangers, strategies, steps."""
