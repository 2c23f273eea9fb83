"""Loom file reading for the port."""
