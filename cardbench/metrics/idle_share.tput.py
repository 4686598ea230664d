"""The device's idle share, in %, of the untraced segment just before the
traced one (as long): 1 - (the union of the layer calls' intervals, each
timed by a CUDA event before and after it) / (the segment, from a tick's
start to a tick's start). The profiler's own cost on graph replays does
not enter it; the traced segment's share is the result's ``device``
``busy_s`` over ``window_s``."""
from cardbench.readings import idle_share


def read(rec):
    return idle_share(rec)
