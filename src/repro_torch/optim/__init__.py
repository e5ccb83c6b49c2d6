"""Optimisation: AdamW with its schedule (``adamw``) and int8
error-feedback gradient compression (``compression``)."""
