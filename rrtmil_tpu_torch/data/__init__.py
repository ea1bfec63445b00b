"""Datasets and bucketing."""
