from .treelearn import TreeLearn, treelearn_loss
from .ptv3 import PointTransformerWithHeads, ptv3_loss
from .pointnet2 import PointNet2, pointnet2_loss
from .loss import point_wise_loss
from .convert import flax_to_state_dict

__all__ = ["TreeLearn", "treelearn_loss", "PointTransformerWithHeads",
           "ptv3_loss", "PointNet2", "pointnet2_loss", "point_wise_loss",
           "flax_to_state_dict"]
