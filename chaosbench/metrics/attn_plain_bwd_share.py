"""attn_plain_bwd_share (plain backwards, ``kernels/ops.py``): the device
time of the kernels launched inside the program's
``flash_attention_plain_backward`` ranges, as a share of all device time
in the traced window."""

RANGES = ("flash_attention_plain_backward",)


def read(run):
    trace = run.trace
    if trace is None or trace.device_s <= 0:
        return None
    inside, _ = trace.ranges.get(RANGES[0], (0.0, 0))
    return 100.0 * inside / trace.device_s if inside > 0 else None
