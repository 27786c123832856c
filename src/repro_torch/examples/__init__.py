"""Scenario models written once as PyTorch handlers."""
