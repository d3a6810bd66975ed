"""throughput_gbps (end to end, host clock): the bytes of every call the
window completed, each input byte read once and each output byte written
once (``work.work``), over the window's length, in 10^9 bytes a second."""


def read(run):
    return sum(run.specs[call[0]].bytes for call in run.calls) / run.window_s / 1e9
