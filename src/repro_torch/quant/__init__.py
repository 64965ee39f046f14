"""Group quantization primitives."""
