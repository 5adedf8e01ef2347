"""Video I/O bridge, device policy and stage timing."""
