"""Serving loops (the twin of ``repro.serve``)."""
