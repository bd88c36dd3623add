"""Checkpoints: save and load every index kind."""
