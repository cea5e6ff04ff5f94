"""device_idle_pct (%, device trace), layer "device": the share of the
traced window in which a card runs no kernel and no copy, the mean over
the cards the cell uses."""


def read(run):
    tr = run.trace
    if tr is None or not tr.events:
        return None
    busy = sum(tr.busy_us(d) for d in tr.devices) / len(tr.devices)
    return 100.0 * (1.0 - busy / tr.window_us)
