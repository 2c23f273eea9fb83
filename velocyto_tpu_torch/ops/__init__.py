"""Numerical stages of the port (device tensors and host numpy)."""
