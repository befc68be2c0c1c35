"""Learning-rate schedules.

Port of ``treemorph_tpu/train/schedule.py`` (copied). The reference trains
with torch ``CosineAnnealingWarmRestarts(T_0=50, eta_min=1e-4)`` stepped
once per batch *with the integer epoch value*
(``train_utils.py:41``, ``train_TreeLearn.py:148-153``) — i.e. the LR is a
function of the epoch index, constant within an epoch. This reproduces that
schedule exactly as a pure function of the epoch.
"""

from __future__ import annotations

import numpy as np


def cosine_annealing_warm_restarts(
    base_lr: float,
    t_0: int = 50,
    t_mult: int = 1,
    eta_min: float = 1e-4,
):
    """Returns ``lr(epoch)`` matching torch's CosineAnnealingWarmRestarts.

    eta(t) = eta_min + (base - eta_min) * (1 + cos(pi * T_cur / T_i)) / 2
    with restarts every ``t_0 * t_mult**k`` epochs.
    """

    def schedule(epoch: float) -> float:
        if t_mult == 1:
            t_cur = epoch % t_0
            t_i = t_0
        else:
            # find the restart cycle containing `epoch`
            n = int(
                np.floor(
                    np.log(epoch / t_0 * (t_mult - 1) + 1) / np.log(t_mult)
                )
            )
            t_cur = epoch - t_0 * (t_mult**n - 1) / (t_mult - 1)
            t_i = t_0 * t_mult**n
        return eta_min + (base_lr - eta_min) * (
            1 + np.cos(np.pi * t_cur / t_i)
        ) / 2.0

    return schedule
