"""Training checkpoints with a metadata manifest.

Port of ``treemorph_tpu/train/checkpoints.py`` without orbax: a checkpoint
is a directory holding ``torch.save`` of the model's ``state_dict``
(:data:`MODEL_FILE`) and of the optimizer's with the step count
(:data:`OPTIMIZER_FILE`), beside a ``{path}.metadata.json`` manifest (model
family, hyperparameters, CV plot, noise threshold). The training CLI writes
them to ``{save_dir}/{name}_CV/P{plot}/``, the JAX package's layout, and
:func:`treemorph_tpu_torch.evaluation.model_loaders.load_model` reads them.
"""

from __future__ import annotations

import json
import os

import torch

MODEL_FILE = "model.pt"
OPTIMIZER_FILE = "optimizer.pt"


def save_checkpoint(path: str, state, metadata: dict | None = None) -> None:
    """Save a :class:`~treemorph_tpu_torch.train.harness.TrainState` (model,
    optimizer and step) and the metadata manifest."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    torch.save(state.model.state_dict(), os.path.join(path, MODEL_FILE))
    torch.save(
        {"optimizer": state.optimizer.state_dict(), "step": state.step},
        os.path.join(path, OPTIMIZER_FILE),
    )
    if metadata is not None:
        with open(path + ".metadata.json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)


def restore_checkpoint(path: str, state):
    """Load a checkpoint written by :func:`save_checkpoint` into ``state``
    (a TrainState of the same architecture) and return it."""
    path = os.path.abspath(path)
    device = next(state.model.parameters()).device
    state.model.load_state_dict(
        torch.load(os.path.join(path, MODEL_FILE), map_location=device)
    )
    saved = torch.load(os.path.join(path, OPTIMIZER_FILE),
                       map_location=device)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = saved["step"]
    return state


def load_metadata(path: str) -> dict | None:
    meta_path = os.path.abspath(path) + ".metadata.json"
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        return json.load(f)
