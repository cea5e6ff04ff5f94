"""shard_wait_ms (ms, device trace), layer "distribution": how long a
card's shard waits for the home card's framing and copies out. Per call,
the mean over the cards but the home card of the device start of the
first operation launched under the card's ``shard.decode`` span, on the
host's clock, less the host time of its launch (``portbench.spans``:
the device clock is set by the call's first operation on the home card,
which finds its card idle); the mean over the calls that pair. None
where the trace holds no ``shard.decode`` span past the home card's."""
from portbench.spans import attribute


def read(run):
    att = attribute(run.trace)
    if att is None:
        return None
    waits = []
    for call in att.shard_waits:
        cards = [w for w in call[1:] if w is not None]
        if cards:
            waits.append(sum(cards) / len(cards))
    return sum(waits) / len(waits) * 1e-3 if waits else None
