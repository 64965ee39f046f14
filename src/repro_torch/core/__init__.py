"""SliceMoE core: AMAT numerics, routing, the slice store, the DBSC cache,
PCW warmup and the engine."""
