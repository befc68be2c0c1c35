"""Model construction and checkpoint loading for the pipeline.

Port of ``treemorph_tpu/evaluation/model_loaders.py``: the pipeline's
fixed hyperparameters (reference ``ModelLoaders.py:31-113``: TreeLearn
num_blocks=3 dim_feat=4 voxel 0.02; PTv3 dim_feat=4 with features, voxel
0.02; PointNet2 depth=5 dim_feat=4), :func:`build_model`, the
:class:`Predictor` the pipeline calls, and :func:`load_model`, which reads
both the port's own checkpoints (:mod:`treemorph_tpu_torch.train.checkpoints`,
``model.pt``) and the JAX package's orbax directories
(``treemorph_tpu/train/checkpoints.py``: ``manifest.ocdbt`` and
``_METADATA``), the latter through
:func:`treemorph_tpu_torch.train.orbax_reader.read_checkpoint` and
:func:`treemorph_tpu_torch.models.convert.flax_to_state_dict`.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import torch

from ..models.convert import flax_to_state_dict
from ..models.pointnet2 import PointNet2
from ..models.ptv3 import PointTransformerWithHeads
from ..models.treelearn import TreeLearn
from ..train.checkpoints import MODEL_FILE, load_metadata
from ..train.orbax_reader import is_orbax_checkpoint, read_checkpoint
from ..utils.device import resolve_device

# Fixed per-family hyperparameters (reference ModelLoaders.py:31-113)
FAMILY_DEFAULTS = {
    "treelearn": dict(
        channels=32, num_blocks=3, dim_feat=4, voxel_size=0.02, kernel_size=3
    ),
    "pointtransformerv3": dict(dim_feat=4, use_feats=True, voxel_size=0.02),
    "pointnet2": dict(depth=5, dim_feat=4, use_coords=True, use_features=True),
}

Model = TreeLearn | PointTransformerWithHeads | PointNet2


@dataclass
class Predictor:
    """A ready-to-call model: family name + module, run in eval mode on
    ``device`` (the CUDA device unless named; raises without one). The
    module is moved there, and so are the inputs of each call."""

    family: str
    model: Model
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model = self.model.to(self.device).eval()

    def predict_flat(self, coords, feats, batch_ids, valid) -> dict:
        """Flat voxel-model layout (treelearn / ptv3)."""
        return self._forward(coords, feats, batch_ids, valid)

    def predict_padded(self, coords, feats, valid) -> dict:
        """Padded (B, N, ...) layout (pointnet2)."""
        return self._forward(coords, feats, valid)

    def _forward(self, *arrays) -> dict:
        args = [torch.as_tensor(a).to(self.device) for a in arrays]
        with torch.inference_mode():
            return self.model(*args)


def build_model(
    model_type: str,
    batch_size: int = 1,
    device=None,
    seed: int = 0,
    **overrides,
) -> Model:
    """A model of the given family with the pipeline's fixed
    hyperparameters (overrides win), initialized from ``seed`` like flax
    initializes it (in distribution), in eval mode on ``device`` (the CUDA
    device unless named; raises without one). ``batch_size`` is
    TreeLearn's static batch-element count; PTv3 and PointNet2 take any."""
    device = resolve_device(device)
    model_type = model_type.lower()
    if model_type not in FAMILY_DEFAULTS:
        raise NotImplementedError(
            f"model family {model_type!r} is not ported yet"
        )
    cfg = dict(FAMILY_DEFAULTS[model_type])
    cfg.update(overrides)
    if model_type == "treelearn":
        model = TreeLearn(batch_size=batch_size, **cfg)
    elif model_type == "pointnet2":
        model = PointNet2(**cfg)
    else:
        model = PointTransformerWithHeads(**cfg)
    generator = torch.Generator().manual_seed(seed)
    model.reset_parameters(generator)
    return model.to(device).eval()


def _plot_from_name(path: str) -> str | None:
    # the reference's "{Model}_P{n}[suffix]" naming and the training CLI's
    # bare "P{n}" checkpoint directories
    m = re.search(r"(?:^|_)P(\d+)(?!\d)", os.path.basename(path))
    return m.group(1) if m else None


def load_model(
    model_type: str,
    offset_model_dir: str | None = None,
    noise_model_dir: str | None = None,
    device=None,
    **build_overrides,
) -> dict[str, Predictor]:
    """Per-plot offset ("O_P{n}") and noise ("N_P{n}") predictors from the
    checkpoint directories under each model directory (one per CV plot,
    with ``P{n}`` in the name, as the training CLIs of both packages write
    them): the port's ``model.pt``, or else the JAX package's orbax
    directory of flax ``{params, batch_stats}``. Metadata manifests
    override the family defaults where not null, and ``build_overrides``
    (an engine, a compute dtype: what a checkpoint does not record) override
    both. Every directory found is loaded, as in the JAX package. Models run
    on ``device`` (the CUDA device unless named; raises without one)."""
    device = resolve_device(device)
    model_type = model_type.lower()
    out: dict[str, Predictor] = {}
    for prefix, model_dir in (("O", offset_model_dir), ("N", noise_model_dir)):
        if model_dir is None or not os.path.isdir(model_dir):
            continue
        for entry in sorted(os.listdir(model_dir)):
            full = os.path.join(model_dir, entry)
            plot = _plot_from_name(entry)
            if not os.path.isdir(full) or plot is None:
                continue
            meta = load_metadata(full) or {}
            overrides = {
                k: v for k, v in meta.items()
                if k in FAMILY_DEFAULTS[model_type] and v is not None
            }
            overrides.update(build_overrides)
            model = build_model(model_type, device=device, **overrides)
            own = os.path.join(full, MODEL_FILE)
            if os.path.exists(own) or not is_orbax_checkpoint(full):
                state = torch.load(own, map_location=device)
            else:
                state = flax_to_state_dict(read_checkpoint(full))
            model.load_state_dict(state)
            out[f"{prefix}_P{plot}"] = Predictor(model_type, model, device)
    return out
