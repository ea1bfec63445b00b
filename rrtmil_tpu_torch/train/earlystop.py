"""Early stopping, mirroring reference utils.py:118-179.

A copy of `rrtmil_tpu/train/earlystop.py`.  Consumes a score to minimize
(the harness passes -AUC, main.py:555); stops after `patience`
non-improving epochs once past `stop_epoch`.  `state_dict` /
`load_state_dict` carry it through a checkpoint (utils.py:155-172).
"""
from __future__ import annotations

import math


class EarlyStopping:
    def __init__(self, patience: int = 20, stop_epoch: int = 50,
                 save_best_model_stage: float = 0.0):
        self.patience = patience
        self.stop_epoch = stop_epoch
        self.save_best_model_stage = save_best_model_stage
        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.val_loss_min = math.inf

    def __call__(self, epoch: int, val_loss: float) -> bool:
        """Returns True when this epoch improved (caller may checkpoint)."""
        score = -val_loss if epoch >= self.save_best_model_stage else 0.0
        if self.best_score is None:
            self.best_score = score
            self.val_loss_min = val_loss
            return True
        if score < self.best_score:
            self.counter += 1
            if self.counter >= self.patience and epoch > self.stop_epoch:
                self.early_stop = True
            return False
        self.best_score = score
        self.val_loss_min = val_loss
        self.counter = 0
        return True

    def state_dict(self):
        return {
            "patience": self.patience,
            "stop_epoch": self.stop_epoch,
            "counter": self.counter,
            "best_score": self.best_score,
            "early_stop": self.early_stop,
            "val_loss_min": self.val_loss_min,
            "save_best_model_stage": self.save_best_model_stage,
        }

    def load_state_dict(self, state):
        for key, value in state.items():
            setattr(self, key, value)
