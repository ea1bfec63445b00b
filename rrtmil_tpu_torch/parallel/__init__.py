"""Parallel training: fold-parallel cross-validation (folds.py)."""
