"""decoded_mbps (Mb/s, host clock): the information bits of every call
completed in the window, over the window's seconds. The window runs from
the first call's issue to the moment the last call's bits were ready."""


def read(run):
    return run.calls * run.cell.n / run.window_s / 1e6
