"""Filters and control loops (reference L3)."""
