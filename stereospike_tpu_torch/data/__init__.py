"""Data: the MVSEC and DENSE datasets and their synthetic fixtures, batching,
augmentation, upload packing, event voxelization on the device, and
synthetic training batches."""
