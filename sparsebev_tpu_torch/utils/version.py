"""Checkpoint back-compat switch (the port's copy of
``sparsebev_tpu/utils/version.py``): ``VERSION.name == 'v0.17.1'`` flips the
yaw-rotation sign convention (read by ``ops/projection.make_sample_points``)
and enables the w/l + yaw swap at decode (``bbox/nms_free_coder.py``).

Set it from the checkpoint's ``version`` tag before running a forward.
"""


class Version:
    def __init__(self):
        self.name = "v1.0.0"


VERSION = Version()
