"""device.idle_share (%): the share of the traced host window (first
enqueue to the synchronize after the last step) in which no operation
ran on the device. None with no device operation in the trace."""


def read(run):
    if not run.kernels:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
