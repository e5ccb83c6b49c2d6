"""Recommendation models (port of the JAX package's ``models/recsys``):
DIN (``din``) and its embedding lookups (``embedding``)."""
