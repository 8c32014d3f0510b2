from .denoising import (build_dn_attn_mask, compute_dn_loss,  # noqa: F401
                        draw_dn_noise, prepare_dn_inputs)
from .focal import focal_loss, focal_loss_cost  # noqa: F401
from .l1 import l1_loss  # noqa: F401
from .matching import hungarian_matching  # noqa: F401
from .target import compute_detection_loss  # noqa: F401
