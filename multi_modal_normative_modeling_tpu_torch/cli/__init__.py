"""Command-line entry points of the port (the test stage so far)."""
