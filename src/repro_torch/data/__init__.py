"""Synthetic federated data streams."""
