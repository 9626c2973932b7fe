"""Serving path of the port: spectral-norm folding, the inference pipeline,
test-time finetune and the serving export."""
