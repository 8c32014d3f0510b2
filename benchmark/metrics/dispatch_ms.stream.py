"""Host milliseconds a sample inside ``StreamingDetector.infer``
(upload, frame pass and head dispatch, the coder's decode), from the
call's entry to its return before the read-back; the mean over the timed
window of a traced run."""


def read(run):
    return run.layer.get("dispatch_ms")
