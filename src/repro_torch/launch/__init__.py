"""Command-line entry points: ``train`` and ``serve``."""
