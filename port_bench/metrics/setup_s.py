"""setup_s (end to end, host clock): from the start of the process to the
first timed call, in seconds."""


def read(run):
    return run.setup_s
