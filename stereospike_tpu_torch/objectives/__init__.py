"""Training losses and depth metrics (masked, static-shape)."""
