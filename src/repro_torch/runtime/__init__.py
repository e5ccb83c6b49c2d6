"""The fault-tolerant training loop (``train_loop``)."""
