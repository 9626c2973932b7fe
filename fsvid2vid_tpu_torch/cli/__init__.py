"""Command-line entry points of the port: training and inference."""
