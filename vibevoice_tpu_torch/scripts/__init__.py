"""Checkpoint tools of the port."""
