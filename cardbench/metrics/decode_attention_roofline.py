"""``decode_attention``'s share of its roofline, in %: the frozen
``costs.decode`` bound of each traced step's layers at the step's live
length (one row: query heads over K/V heads, keys 0..pos), summed, over
the device time of the kernel's split and combine launches."""
from cardbench import costs
from cardbench.readings import group_s, share, traced


def read(rec):
    m = rec.m
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    bound = busy = 0.0
    for (_, _, _, pos, _), _, ks in traced(rec, "decode"):
        live = pos + 1
        ms, _ = costs.bound(*costs.decode(H, KV, hd, m["dtype"], H * live,
                                          KV * live))
        bound += m["n_layers"] * ms / 1e3
        busy += group_s(ks, "decode_attention")
    return share(bound, busy)
