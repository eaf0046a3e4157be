"""Synthetic datasets and the Dirichlet non-IID partitioner (pure numpy)."""
