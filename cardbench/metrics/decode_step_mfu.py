"""The whole graphed decode step's share of the card's roofline, in %: for
the traced decode steps, the larger of their operations over the bf16
peak and their bytes over HBM's rate (the weights a token needs, routed
experts only, and the K/V cache at each step's live length; the frozen
``costs.decode_step``), summed, over the device time of their operations."""
from cardbench import costs
from cardbench.readings import device_s, share, traced


def read(rec):
    bound = busy = 0.0
    for (_, _, _, pos, _), _, ks in traced(rec, "decode"):
        nbytes, flops = costs.decode_step(rec.m, pos + 1)
        bound += max(nbytes / costs.HBM_BW, flops / costs.PEAK_FLOPS_BF16)
        busy += device_s(ks)
    return share(bound, busy)
