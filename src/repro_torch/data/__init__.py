"""Synthetic data: graph generators (``graphgen``) and the LM token stream
(``tokens``)."""
