"""Atomic, checksummed snapshots (``manager``): the round journal's store."""
