"""Device milliseconds a sample from the frame pass's start
(``forward_frame_packed``: normalize, backbone, FPN, pack) to the end of
its ring write (``ring_update``), by CUDA events; the mean over the timed
window of a traced run."""


def read(run):
    return run.layer.get("frame_pass_ms")
