"""Synthetic datasets and the Dirichlet non-IID partitioner (numpy draws;
the LM token stream comes back as a tensor)."""
