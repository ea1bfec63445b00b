"""Evaluation engine and metrics."""
