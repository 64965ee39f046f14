"""Checkpoint save/restore in the reference's on-disk format."""
