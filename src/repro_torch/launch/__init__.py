"""Command-line entry points (the twin of ``repro.launch``)."""
