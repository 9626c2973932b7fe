"""Serving path of the port: spectral-norm folding and the inference pipeline."""
