"""The PyTorch / H100 port's benchmark: `python -m benchmark.run` (see run.py)."""
