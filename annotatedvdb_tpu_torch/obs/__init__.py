"""Serving observability: metrics, request traces and the health plane
(the time-series ring, SLO alerts and the crash flight recorder)."""
