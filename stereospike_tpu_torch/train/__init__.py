"""Serving loop, run configuration, train state and train step."""
