"""treemorph_tpu_torch — the PyTorch + CUDA port of ``treemorph_tpu`` for one
NVIDIA H100.

The package mirrors ``treemorph_tpu``'s layout module for module, so each
function's counterpart is found at the same path. It imports ``torch`` and
never ``jax``, and nothing of ``treemorph_tpu``: what it needs from there it
keeps as its own copy. The JAX package stays the reference the port is held
against (``tests/test_torch_*.py``).

Layout:
    csrc/        hand-written CUDA kernels (built with nvcc at first use)
    ops/         voxelize, rulebook + gather conv, point dedup, band and
                 z-band convs, brick layout and brick conv, window
                 attention (forward and backward), z-order and Hilbert
                 codes
    models/      TreeLearn and PTv3 as torch modules, their losses, the
                 flax weight bridge
    data/        labeled-tree datasets, padded batches, augmentations
    train/       harness (optimizer, train/eval steps, epoch loop),
                 families, schedule, checkpoints, the training CLI
    evaluation/  build_model / Predictor / load_model
    pipeline/    stage1 predict / stage2 upsample / stage3 QSM fit / run
    native/      the QSM stage's C++ core behind ctypes
    utils/       host IO, fitting helpers, mesh export, the CSV table,
                 early stopping
    fixtures/    synthetic QSM / tree-cloud generators
    scripts/     profile_zband (z-band vs band vs gather engines)

Entry points (``build_model``, ``Predictor``, ``load_model``,
``predict_single``, ``upsample``, ``run_pipeline``, the training CLI
``python -m treemorph_tpu_torch.train.cli``) run on the CUDA device unless
the caller passes ``device="cpu"``; without a CUDA device the default
raises.
"""

__version__ = "0.1.0"
