"""Logging facade: console + optional Weights&Biases + TensorBoard(X).

A copy of `rrtmil_tpu/utils/logger.py` (the reference's logging surface,
main.py:288-356 wandb rows): wandb and tensorboardX are optional imports,
disabled with a console note when absent.
"""
from __future__ import annotations

from typing import Dict, Optional


class Logger:
    def __init__(self, use_wandb: bool = False, project: str = "",
                 name: str = "", config=None, log_dir: Optional[str] = None,
                 use_tensorboard: bool = False, quiet: bool = False,
                 wandb_id: Optional[str] = None):
        self.quiet = quiet
        self._wandb = None
        self._tb = None
        if use_wandb:
            try:
                import wandb
                kwargs = dict(project=project, name=name, config=config,
                              dir=log_dir)
                if wandb_id:
                    kwargs.update(id=wandb_id, resume="must")
                self._wandb = wandb
                wandb.init(**kwargs)
            except ImportError:
                self.print("[logger] wandb not installed; disabled")
        if use_tensorboard and log_dir:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except ImportError:
                self.print("[logger] tensorboardX not installed; disabled")

    @property
    def wandb_id(self) -> str:
        return self._wandb.run.id if self._wandb else ""

    def print(self, *args):
        if not self.quiet:
            print(*args, flush=True)

    def log(self, row: Dict[str, float], step: Optional[int] = None,
            commit: bool = True):
        if self._wandb:
            self._wandb.log(row, commit=commit)
        if self._tb and step is not None:
            for key, value in row.items():
                try:
                    self._tb.add_scalar(key, float(value), step)
                except (TypeError, ValueError):
                    pass

    def finish(self):
        if self._wandb:
            self._wandb.finish()
        if self._tb:
            self._tb.close()
