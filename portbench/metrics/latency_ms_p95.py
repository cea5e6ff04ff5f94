"""latency_ms_p95 (ms, host clock): the 95th percentile, over every call
completed in the window, of the time from the client issuing the call to
its bits being where the client needs them (numpy's linear percentile)."""
import numpy as np


def read(run):
    return float(np.percentile(run.latency_s, 95)) * 1e3
