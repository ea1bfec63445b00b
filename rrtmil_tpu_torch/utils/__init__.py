"""Initializers, MAC counts and device selection."""
