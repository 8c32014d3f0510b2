"""Device milliseconds a sample from the ring view (``ring_packed``)
to the end of the coder's ``decode`` (the head's six decoder layers,
sampling, mixing and predictions), by CUDA events; the mean over the timed
window of a traced run."""


def read(run):
    return run.layer.get("head_ms")
