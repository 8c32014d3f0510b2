from .box3d import Boxes3D, quaternion_to_rotation_matrix  # noqa: F401
from .dataset import NuScenesSweepDataset  # noqa: F401
from . import pipelines  # noqa: F401
from .loader import DataLoader, ShardedGroupSampler, collate_batch  # noqa: F401
from .synthetic import make_synthetic_dataset  # noqa: F401
