"""Serving metrics and request traces."""
