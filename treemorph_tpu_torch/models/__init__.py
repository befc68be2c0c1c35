from .treelearn import TreeLearn
from .convert import flax_to_state_dict

__all__ = ["TreeLearn", "flax_to_state_dict"]
