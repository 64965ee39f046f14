"""Model stack, MoE layer and transformer building blocks."""
