"""Continuous-batching serving over the persistent SliceMoE engine."""
