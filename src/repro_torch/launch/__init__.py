"""Launch layer: the training entry point and its step function."""
