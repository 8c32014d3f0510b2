"""Device milliseconds a sample under the port's ``eva02.global_block``
spans (the trunk's 8 global blocks of a frame pass), by the tracer's CUDA
events over the timed window of a traced run; None where the port has no
such span."""

from harness import spans


def read(run):
    return spans.per_unit(run, "eva02.global_block", "device_ms",
                          "stream.infer")
