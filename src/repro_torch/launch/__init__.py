"""Launch layer: meshes, sharding, input specs, step factories, the
train and serve entry points and the shape dry-run."""
