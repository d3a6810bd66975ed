"""device_idle_pct (device, device trace): the share of the traced segment
in which no operation ran on the device, in percent."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return (1 - run.trace.busy_s() / run.trace.window_s) * 100
