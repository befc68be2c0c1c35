"""Model construction for the pipeline.

Port of ``treemorph_tpu/evaluation/model_loaders.py`` for TreeLearn: the
pipeline's fixed hyperparameters (reference ``ModelLoaders.py:31-113``:
TreeLearn num_blocks=3 dim_feat=4 voxel 0.02), :func:`build_model` and the
:class:`Predictor` the pipeline calls. Loading checkpoints is not ported
yet: models are built here and given their weights by the caller (seeded
initialization, or :func:`treemorph_tpu_torch.models.convert.flax_to_state_dict`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.treelearn import TreeLearn
from ..utils.device import resolve_device

# Fixed per-family hyperparameters (reference ModelLoaders.py:31-113)
FAMILY_DEFAULTS = {
    "treelearn": dict(
        channels=32, num_blocks=3, dim_feat=4, voxel_size=0.02, kernel_size=3
    ),
}


@dataclass
class Predictor:
    """A ready-to-call model: family name + module, run in eval mode on
    ``device`` (the CUDA device unless named; raises without one). The
    module is moved there, and so are the inputs of each call."""

    family: str
    model: TreeLearn
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model = self.model.to(self.device).eval()

    def predict_flat(self, coords, feats, batch_ids, valid) -> dict:
        """Flat voxel-model layout (treelearn)."""
        args = [
            torch.as_tensor(a).to(self.device)
            for a in (coords, feats, batch_ids, valid)
        ]
        with torch.inference_mode():
            return self.model(*args)


def build_model(
    model_type: str,
    batch_size: int = 1,
    device=None,
    seed: int = 0,
    **overrides,
) -> TreeLearn:
    """A model of the given family with the pipeline's fixed
    hyperparameters (overrides win), initialized from ``seed`` like flax
    initializes it, in eval mode on ``device`` (the CUDA device unless
    named; raises without one)."""
    device = resolve_device(device)
    model_type = model_type.lower()
    if model_type != "treelearn":
        raise NotImplementedError(
            f"model family {model_type!r} is not ported yet"
        )
    cfg = dict(FAMILY_DEFAULTS[model_type])
    cfg.update(overrides)
    model = TreeLearn(batch_size=batch_size, **cfg)
    generator = torch.Generator().manual_seed(seed)
    model.reset_parameters(generator)
    return model.to(device).eval()
