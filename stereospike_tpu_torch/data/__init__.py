"""Event voxelization on the device, and synthetic training batches."""
