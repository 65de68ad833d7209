"""Logging sinks and profiling hooks."""
