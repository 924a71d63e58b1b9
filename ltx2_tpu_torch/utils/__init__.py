"""Utilities: the model ledger."""
