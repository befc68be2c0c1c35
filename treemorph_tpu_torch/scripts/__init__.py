"""Command-line scripts of the port that have no home in another
subpackage, run with ``python -m treemorph_tpu_torch.scripts.<name>``."""
