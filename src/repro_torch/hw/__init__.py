"""Hardware profiles and the offload cost model."""
