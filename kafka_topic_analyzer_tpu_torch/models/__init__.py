"""Analyzer state (dataclasses of tensors)."""
