"""Patience-based early stopping with best-checkpoint saving.

Port of ``treemorph_tpu/utils/early_stopping.py`` (copied), with parity to
reference ``Modules/Utils.py:10-54``: the caller supplies a ``save_fn``
(e.g. :func:`treemorph_tpu_torch.train.checkpoints.save_checkpoint`).
"""

from __future__ import annotations

from typing import Callable, Optional


class EarlyStopper:
    def __init__(
        self,
        patience: int = 5,
        verbose: bool = False,
        save_fn: Optional[Callable] = None,
    ):
        self.patience = patience
        self.verbose = verbose
        self.save_fn = save_fn
        self.counter = 0
        self.best_loss: Optional[float] = None
        self.train_loss: Optional[float] = None
        self.early_stop = False

    def __call__(self, state, train_loss: float, val_loss: float) -> None:
        """Record one epoch; save ``state`` via ``save_fn`` on improvement."""
        if self.best_loss is None or val_loss < self.best_loss:
            self.best_loss = val_loss
            self.train_loss = train_loss
            self.counter = 0
            if self.save_fn is not None:
                self.save_fn(state)
        else:
            self.counter += 1
            if self.verbose:
                print(
                    f"Validation loss did not improve. "
                    f"Counter: {self.counter}/{self.patience}"
                )
            if self.counter >= self.patience:
                self.early_stop = True

    def get_scores(self):
        return self.train_loss, self.best_loss
