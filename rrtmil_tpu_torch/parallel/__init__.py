"""Parallel training: fold-parallel cross-validation (folds.py); ranks on a
(dp, sp) grid (mesh.py), their collectives (collectives.py), sequence
sharding over the region axis (seqshard.py) and the dp x sp train step
(train.py)."""
